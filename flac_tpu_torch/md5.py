"""The STREAMINFO MD5 contract.

Two parts:

1. The packing contract (md5.c:271-418 format_input_): decoded PCM with
   channels interleaved, each sample little-endian at ``(bps + 7) // 8``
   bytes, two's complement.

2. The hash itself. NOTE: the reference's MD5 core is NOT standard MD5 — its
   SWAP_BE_WORD_TO_HOST macro (md5.c:23-33) loads each 64-byte block's data
   words *big-endian* (the condition is inverted relative to the standard
   little-endian MD5 word order), while the 64-bit length trailer is still
   appended in host little-endian order (md5.c:252-255). The digest therefore
   differs from hashlib.md5 on every input. Since the STREAMINFO md5sum must
   match what the reference `flac` binary writes and verifies, this module
   implements that exact variant (independently, from the MD5 spec plus the
   reference's word-order behavior).

A C implementation lives in the native runtime extension for throughput; this
Python version is the reference/fallback.
"""

from __future__ import annotations

import struct

import numpy as np

try:
    from flac_tpu_torch._native import StreamingMD5 as _NativeStreamingMD5  # type: ignore
except Exception:  # pragma: no cover - native ext optional
    _NativeStreamingMD5 = None


def pack_samples(signal: np.ndarray, bps: int) -> bytes:
    """Pack [nsamples, nchannels] int32 PCM into the MD5 byte format."""
    if signal.ndim == 1:
        signal = signal[:, None]
    bytes_per_sample = (bps + 7) // 8
    flat = np.ascontiguousarray(signal, dtype=np.int32).reshape(-1)
    if bytes_per_sample == 1:
        return flat.astype(np.int8).tobytes()
    if bytes_per_sample == 2:
        return flat.astype("<i2").tobytes()
    if bytes_per_sample == 4:
        return flat.astype("<i4").tobytes()
    if bytes_per_sample == 3:
        le = flat.astype("<i4").view(np.uint8).reshape(-1, 4)
        return np.ascontiguousarray(le[:, :3]).tobytes()
    raise ValueError(f"unsupported bytes per sample: {bytes_per_sample}")


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


# standard MD5 round constants/shifts (RFC 1321)
_S = ((7, 12, 17, 22), (5, 9, 14, 20), (4, 11, 16, 23), (6, 10, 15, 21))
_K = [int(abs(__import__("math").sin(i + 1)) * 2**32) & 0xFFFFFFFF for i in range(64)]
_IDX = (
    [i for i in range(16)],
    [(1 + 5 * i) % 16 for i in range(16)],
    [(5 + 3 * i) % 16 for i in range(16)],
    [(7 * i) % 16 for i in range(16)],
)


def _transform(state: list[int], words: list[int]) -> None:
    a, b, c, d = state
    for rnd in range(4):
        for i in range(16):
            if rnd == 0:
                f = d ^ (b & (c ^ d))
            elif rnd == 1:
                f = c ^ (d & (b ^ c))
            elif rnd == 2:
                f = b ^ c ^ d
            else:
                f = c ^ (b | (~d & 0xFFFFFFFF))
            g = _IDX[rnd][i]
            tmp = (a + f + _K[rnd * 16 + i] + words[g]) & 0xFFFFFFFF
            a, d, c, b = d, c, b, (b + _rotl(tmp, _S[rnd][i % 4])) & 0xFFFFFFFF
    state[0] = (state[0] + a) & 0xFFFFFFFF
    state[1] = (state[1] + b) & 0xFFFFFFFF
    state[2] = (state[2] + c) & 0xFFFFFFFF
    state[3] = (state[3] + d) & 0xFFFFFFFF


class FlacMD5:
    """MD5 with the reference's big-endian data-word loading."""

    def __init__(self) -> None:
        self.state = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476]
        self.buffer = b""
        self.length = 0

    def update(self, data: bytes) -> None:
        self.length += len(data)
        self.buffer += data
        nblocks = len(self.buffer) // 64
        if nblocks:
            blocks = np.frombuffer(self.buffer[: 64 * nblocks], dtype=">u4").reshape(-1, 16)
            for blk in blocks:
                _transform(self.state, [int(w) for w in blk])
            self.buffer = self.buffer[64 * nblocks:]

    def digest(self) -> bytes:
        # final block: data + 0x80 pad, words loaded big-endian; the 64-bit
        # bit-length trailer is appended as two host-little-endian words
        # (md5.c FLAC__MD5Final:225-258)
        buf = self.buffer + b"\x80"
        if len(buf) > 56:
            buf = buf.ljust(64, b"\x00")
            words = [int(w) for w in np.frombuffer(buf, dtype=">u4")]
            state = list(self.state)
            _transform(state, words)
            buf = b""
        else:
            state = list(self.state)
        buf = buf.ljust(56, b"\x00")
        words = [int(w) for w in np.frombuffer(buf, dtype=">u4")]
        bitlen = (self.length << 3) & 0xFFFFFFFFFFFFFFFF
        words.append(bitlen & 0xFFFFFFFF)
        words.append((bitlen >> 32) & 0xFFFFFFFF)
        _transform(state, words)
        return struct.pack("<4I", *state)


class MD5Context:
    """Streaming MD5 over the packed-sample format
    (FLAC__MD5Init/Accumulate/Final)."""

    def __init__(self) -> None:
        self._md5 = _NativeStreamingMD5() if _NativeStreamingMD5 else FlacMD5()

    def accumulate(self, signal: np.ndarray, bps: int) -> None:
        self._md5.update(pack_samples(signal, bps))

    def digest(self) -> bytes:
        return self._md5.digest()


def md5_of_pcm(signal: np.ndarray, bps: int) -> bytes:
    ctx = MD5Context()
    ctx.accumulate(signal, bps)
    return ctx.digest()
