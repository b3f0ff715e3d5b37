"""A small FLAC writer for the tests: frames put together field by field
from the format (RFC 9639), so that the reference meets every subframe
type, order, stereo mode and residual coding whether or not an encoder
would choose it."""

from __future__ import annotations

import numpy as np

from cardbench.reference import crc
from cardbench.reference.md5 import flac_md5

FIXED = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))


class Bits:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        value &= (1 << n) - 1
        self.bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def unary(self, q: int) -> None:
        self.bits.extend([0] * q + [1])

    def align(self) -> None:
        self.bits.extend([0] * (-len(self.bits) % 8))

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        return np.packbits(np.asarray(self.bits, np.uint8)).tobytes()


def _rice(w: Bits, res: np.ndarray, order: int, T: int, porder: int, params,
          method: int = 0) -> None:
    """Partitioned Rice residual; a param of None escapes the partition
    with raw values of the width it needs."""
    w.put(method, 2)
    w.put(porder, 4)
    pbits, esc = (4, 15) if method == 0 else (5, 31)
    part = T >> porder
    at = 0
    for j in range(1 << porder):
        n = part - (order if j == 0 else 0)
        vals = res[at:at + n]
        at += n
        k = params[j]
        if k is None:
            width = int(max((int(abs(v)).bit_length() + 1 for v in vals), default=0))
            w.put(esc, pbits)
            w.put(width, 5)
            for v in vals:
                w.put(int(v), width)
            continue
        w.put(k, pbits)
        for v in vals:
            u = -2 * int(v) - 1 if v < 0 else 2 * int(v)
            w.unary(u >> k)
            w.put(u & ((1 << k) - 1), k)


def subframe(w: Bits, x: np.ndarray, bps: int, kind: str, order: int = 0,
             coefs=(), prec: int = 0, shift: int = 0, porder: int = 0, params=None,
             wasted: int = 0, method: int = 0) -> None:
    """One subframe of samples x (already carrying `wasted` zero low bits)."""
    x = np.asarray(x, np.int64) >> wasted
    ebps = bps - wasted
    code = {"constant": 0, "verbatim": 1, "fixed": 8 + order, "lpc": 31 + order}[kind]
    w.put(0, 1)
    w.put(code, 6)
    if wasted:
        w.put(1, 1)
        w.unary(wasted - 1)
    else:
        w.put(0, 1)
    if kind == "constant":
        w.put(int(x[0]), ebps)
        return
    if kind == "verbatim":
        for v in x:
            w.put(int(v), ebps)
        return
    for v in x[:order]:
        w.put(int(v), ebps)
    if kind == "fixed":
        coefs, shift = FIXED[order], 0
    else:
        w.put(prec - 1, 4)
        w.put(shift, 5)
        for c in coefs:
            w.put(int(c), prec)
    res = np.asarray([x[i] - (sum(int(c) * int(x[i - 1 - j]) for j, c in enumerate(coefs))
                              >> shift) for i in range(order, len(x))], np.int64)
    if params is None:
        params = [4] * (1 << porder)
    _rice(w, res, order, len(x), porder, params, method)


BS_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9, 1024: 10,
            2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}
SR_CODES = {44100: 9, 48000: 10, 96000: 11}
BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def frame(number: int, T: int, rate: int, bps: int, assignment: int, subframes) -> bytes:
    """A frame: header with CRC-8, the subframes (each a function taking
    the bit writer), zero bits to the byte, CRC-16."""
    w = Bits()
    w.put(0xFFF8, 16)
    code = BS_CODES.get(T, 7)
    w.put(code, 4)
    w.put(SR_CODES[rate], 4)
    w.put(assignment, 4)
    w.put(BPS_CODES[bps], 3)
    w.put(0, 1)
    if number < 0x80:
        w.put(number, 8)
    else:  # two bytes are enough for the tests
        w.put(0xC0 | (number >> 6), 8)
        w.put(0x80 | (number & 0x3F), 8)
    if code == 7:
        w.put(T - 1, 16)
    head = w.bytes()
    w.put(crc.crc8(head), 8)
    for sub in subframes:
        sub(w)
    w.align()
    body = w.bytes()
    return body + crc.crc16(body).to_bytes(2, "big")


def stream(frames: list[bytes], pcm: np.ndarray, rate: int, bps: int, blocksize: int) -> bytes:
    """fLaC, STREAMINFO (last metadata block), then the frames."""
    sizes = [len(f) for f in frames]
    v = (rate << 44) | ((pcm.shape[1] - 1) << 41) | ((bps - 1) << 36) | len(pcm)
    info = (blocksize.to_bytes(2, "big") * 2 + min(sizes).to_bytes(3, "big")
            + max(sizes).to_bytes(3, "big") + v.to_bytes(8, "big") + flac_md5(pcm, bps))
    return b"fLaC" + bytes([0x80, 0, 0, 34]) + info + b"".join(frames)
