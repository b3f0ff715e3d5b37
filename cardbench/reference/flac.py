"""A plain FLAC decoder, written from the format (RFC 9639) in PyTorch
tensor operations, that checks what an encoder wrote.

It decodes fixed-blocksize streams: STREAMINFO and the metadata chain,
every frame header with its CRC-8, constant, verbatim, fixed and LPC
subframes with wasted bits, Rice and Rice2 residuals with escaped
partitions, the four stereo decorrelations and every frame's CRC-16. It
runs on any device: the benchmark runs it on the card once a run's window
has closed, the tests on the CPU.

Frames are found as a parallel decoder finds them, without a sequential
parse: every byte pair 0xFF 0xF8 after the metadata is a candidate, its
header is read and its CRC-8 checked, and every candidate that passes is
decoded, all of them at once, one lane a candidate, stepping through the
samples in lockstep. The frames of a stream are then the chain that
starts at the first audio byte, each frame starting where the one before
ended and carrying the next frame number; a candidate off the chain (a
sync pattern inside a frame's data) is dropped. A break in the chain, a
CRC that does not match, a reserved code or a read past the stream's end
is reported for its stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from cardbench.reference import crc

_I64 = torch.int64

SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
                7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
SAMPLE_BITS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
FIXED_COEFFS = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))
LANES_PER_BLOCK = 16384


class RefError(Exception):
    """A stream that cannot be read at all (no marker, no STREAMINFO)."""


@dataclass
class StreamInfo:
    min_blocksize: int
    max_blocksize: int
    min_framesize: int
    max_framesize: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int
    md5: bytes


@dataclass
class Decoded:
    """One stream as the reference read it: its STREAMINFO, its PCM (int32
    [n, channels]: the frames of the chain, in order), each frame's byte
    size, and what went wrong (empty for a sound stream)."""

    streaminfo: StreamInfo
    pcm: np.ndarray
    frame_sizes: np.ndarray
    errors: list[str] = field(default_factory=list)


def parse_metadata(data: bytes) -> tuple[StreamInfo, int]:
    """(STREAMINFO, the offset of the first audio byte)."""
    if data[:4] != b"fLaC":
        raise RefError("no fLaC marker")
    pos, si, last = 4, None, False
    while not last:
        if pos + 4 > len(data):
            raise RefError("metadata runs past the end")
        head = data[pos]
        last, kind = bool(head & 0x80), head & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if len(body) < length:
            raise RefError("metadata block runs past the end")
        if kind == 0:
            if si is not None or length != 34 or pos != 4:
                raise RefError("STREAMINFO is not the one first block of 34 bytes")
            v = int.from_bytes(body[10:18], "big")
            si = StreamInfo(
                min_blocksize=int.from_bytes(body[0:2], "big"),
                max_blocksize=int.from_bytes(body[2:4], "big"),
                min_framesize=int.from_bytes(body[4:7], "big"),
                max_framesize=int.from_bytes(body[7:10], "big"),
                sample_rate=v >> 44, channels=((v >> 41) & 7) + 1,
                bits_per_sample=((v >> 36) & 31) + 1, total_samples=v & ((1 << 36) - 1),
                md5=bytes(body[18:34]))
        elif kind == 127:
            raise RefError("metadata block of the forbidden type 127")
        pos += 4 + length
    if si is None:
        raise RefError("no STREAMINFO")
    return si, pos


# -- frame headers, on the host, all candidates at once -----------------------


def _headers(d: np.ndarray, audio: int, si: StreamInfo) -> dict:
    """Every candidate frame start in d[audio:] whose header parses, passes
    its CRC-8 and fits the stream's geometry: byte offset, header bytes,
    blocksize, channel assignment, frame number."""
    n = len(d)
    pad = np.concatenate([d, np.zeros(24, np.uint8)]).astype(np.int64)
    c = np.flatnonzero((d[audio:n - 1] == 0xFF) & (d[audio + 1:n] == 0xF8)) + audio
    b2, b3 = pad[c + 2], pad[c + 3]
    bs_code, sr_code = b2 >> 4, b2 & 15
    ch_code, bps_code = b3 >> 4, (b3 >> 1) & 7
    ok = (bs_code != 0) & (sr_code != 15) & (ch_code <= 10) & (bps_code != 3) & ((b3 & 1) == 0)
    # the frame number, UTF-8 coded in 1 to 6 bytes
    u0 = pad[c + 4]
    nb = np.select([u0 < 0x80, u0 < 0xC0, u0 < 0xE0, u0 < 0xF0, u0 < 0xF8, u0 < 0xFC,
                    u0 < 0xFE], [1, 0, 2, 3, 4, 5, 6], 0)
    ok &= nb > 0
    lead_bits = np.where(nb == 1, 7, 7 - nb)
    number = u0 & ((1 << lead_bits) - 1)
    for j in range(1, 6):
        more = j < nb
        b = pad[c + 4 + j]
        ok &= ~more | ((b & 0xC0) == 0x80)
        number = np.where(more, (number << 6) | (b & 0x3F), number)
    pos = c + 4 + np.maximum(nb, 1)
    bs = np.select([bs_code == 1, (bs_code >= 2) & (bs_code <= 5), bs_code == 6,
                    bs_code == 7, bs_code >= 8],
                   [192, 576 << np.clip(bs_code - 2, 0, 3), pad[pos] + 1,
                    ((pad[pos] << 8) | pad[pos + 1]) + 1, 256 << np.clip(bs_code - 8, 0, 7)], 0)
    pos = pos + np.where(bs_code == 6, 1, np.where(bs_code == 7, 2, 0))
    rate = np.select([sr_code == 0, sr_code == 12, (sr_code == 13) | (sr_code == 14)],
                     [si.sample_rate, pad[pos] * 1000,
                      ((pad[pos] << 8) | pad[pos + 1]) * np.where(sr_code == 14, 10, 1)],
                     np.vectorize(lambda k: SAMPLE_RATES.get(int(k), 0), otypes=[np.int64])(sr_code)
                     if len(c) else 0)
    pos = pos + np.where(sr_code == 12, 1, np.where((sr_code == 13) | (sr_code == 14), 2, 0))
    bits = np.where(bps_code == 0, si.bits_per_sample,
                    np.vectorize(lambda k: SAMPLE_BITS.get(int(k), 0), otypes=[np.int64])(bps_code)
                    if len(c) else 0)
    channels = np.where(ch_code <= 7, ch_code + 1, 2)
    hlen = pos - c
    ok &= crc.crc8_rows(pad, c, hlen) == pad[np.minimum(pos, len(pad) - 1)]
    ok &= (bits == si.bits_per_sample) & (channels == si.channels) & (rate == si.sample_rate)
    ok &= (bs >= 1) & (bs <= max(si.max_blocksize, 16))
    keep = np.flatnonzero(ok)
    return dict(start=c[keep], header=hlen[keep] + 1, blocksize=bs[keep],
                assignment=ch_code[keep], number=number[keep])


# -- bit reads over a word array, one position a lane --------------------------


def _read(W: torch.Tensor, pos: torch.Tensor, n) -> torch.Tensor:
    """The n bits (0 to 33; n an int or a tensor like pos) at each bit
    position `pos` of the big-endian 32-bit words W (int64 holding uint32),
    as unsigned values."""
    wi = torch.clamp(pos >> 5, 0, W.numel() - 2)
    v = (W[wi] << 32) | W[wi + 1]
    shift = torch.clamp(64 - (pos & 31) - n, 0, 63)
    mask = (1 << n) - 1 if isinstance(n, int) else (torch.ones_like(n) << n) - 1
    return (v >> shift) & mask


def _signed(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    sign = (v >> torch.clamp(n - 1, min=0)) & (n > 0).to(_I64)
    return v - (sign << n)


class _Lanes:
    """The candidates of one block as lanes: the words, each lane's bit
    position and end, and which lanes went wrong."""

    def __init__(self, W: torch.Tensor, pos: torch.Tensor, end_bits: torch.Tensor):
        self.W, self.pos, self.end_bits = W, pos, end_bits
        self.bad = torch.zeros_like(pos, dtype=torch.bool)

    def take(self, n, mask=None, signed=False) -> torch.Tensor:
        """Read n bits (an int or a tensor like pos; where mask) and advance."""
        if isinstance(n, int):
            n = torch.full_like(self.pos, n)
        if mask is not None:
            n = torch.where(mask, n, 0)
        v = _read(self.W, self.pos, n)
        self.pos = self.pos + n
        return _signed(v, n) if signed else v

    def unary(self, mask: torch.Tensor) -> torch.Tensor:
        """The count of 0 bits before the next 1 bit (where mask), which is
        consumed too; a lane that reaches the stream's end is marked bad."""
        q = torch.zeros_like(self.pos)
        mask = mask & ~self.bad
        while True:
            x = _read(self.W, self.pos, 32)
            z = mask & (x == 0)
            if not bool(z.any()):
                break
            q = q + torch.where(z, 32, 0)
            self.pos = self.pos + torch.where(z, 32, 0)
            off = z & (self.pos >= self.end_bits)
            self.bad |= off
            mask = mask & ~off
        zeros = 32 - torch.frexp(x.to(torch.float64))[1].to(_I64)
        q = q + torch.where(mask, zeros, 0)
        self.pos = self.pos + torch.where(mask, zeros + 1, 0)
        return q


def _subframe(ln: _Lanes, live: torch.Tensor, T: torch.Tensor, bits: torch.Tensor,
              Tmax: int) -> torch.Tensor:
    """Decode one subframe in every live lane: int64 [L, Tmax] samples."""
    dev = ln.pos.device
    L = ln.pos.numel()
    pad = ln.take(1, live)
    kind = ln.take(6, live)
    has_wasted = ln.take(1, live) == 1
    wasted = torch.where(has_wasted, ln.unary(live & has_wasted) + 1, 0)
    ebits = bits - wasted
    const = live & (kind == 0)
    verb = live & (kind == 1)
    fixed = live & (kind >= 8) & (kind <= 12)
    lpc = live & (kind >= 32)
    coded = fixed | lpc
    ln.bad |= live & ((pad != 0) | ~(const | verb | coded) | (ebits < 1))
    order = torch.where(fixed, kind - 8, torch.where(lpc, (kind & 31) + 1, 0))

    cval = ln.take(ebits, const, signed=True)
    maxord = int(order.max()) if L else 0
    warm = torch.zeros((L, max(maxord, 1)), dtype=_I64, device=dev)
    for j in range(maxord):
        warm[:, j] = ln.take(ebits, coded & (j < order), signed=True)
    prec = ln.take(4, lpc) + 1
    shift = ln.take(5, lpc, signed=True)
    ln.bad |= lpc & ((prec == 16) | (shift < 0))
    coef = torch.zeros((L, max(maxord, 1)), dtype=_I64, device=dev)
    for j in range(maxord):
        coef[:, j] = ln.take(prec, lpc & (j < order), signed=True)
    for o, cs in enumerate(FIXED_COEFFS[:maxord + 1]):
        for j, cv in enumerate(cs):
            coef[:, j] = torch.where(fixed & (order == o), cv, coef[:, j])
    shift = torch.where(lpc, shift, 0)

    # the residual: method, partition order, then the partitions
    method = ln.take(2, coded)
    porder = ln.take(4, coded)
    ln.bad |= coded & (method > 1)
    part = T >> porder
    ln.bad |= coded & (((part << porder) != T) | (part < order))
    pbits = torch.where(method == 0, 4, 5)
    escape = torch.where(method == 0, 15, 31)
    # a first partition left empty by the warm-up still holds its parameter
    empty0 = coded & (porder > 0) & (part == order)
    p0 = ln.take(pbits, empty0)
    ln.take(5, empty0 & (p0 == escape))
    coded = coded & ~ln.bad

    starts = set()
    host = torch.stack([order, part, T, coded.to(_I64)]).cpu().numpy()
    for o, p, t in zip(*host[:3, host[3] == 1]):
        starts.add(int(o))
        starts.update(range(int(p), int(t), int(p)))
    res = torch.zeros((L, Tmax), dtype=_I64, device=dev)
    k = torch.zeros_like(ln.pos)
    esc = torch.zeros_like(coded)
    esc_bits = torch.zeros_like(ln.pos)
    any_esc = False
    any_verb = bool(verb.any())
    lo = torch.where(coded, order, Tmax)
    for i in range(Tmax):
        run = (i >= lo) & (i < T)
        if i in starts:
            first = run & ((i == order) | (i % part == 0))
            param = ln.take(pbits, first)
            is_esc = first & (param == escape)
            eb = ln.take(5, is_esc)
            k = torch.where(first, param, k)
            esc = torch.where(first, is_esc, esc)
            esc_bits = torch.where(is_esc, eb, esc_bits)
            any_esc = bool(esc.any())
        rice = run & ~esc
        q = ln.unary(rice)
        low = ln.take(k, rice)
        u = (q << k) | low
        val = torch.where(rice, (u >> 1) ^ -(u & 1), 0)
        if any_esc or any_verb:
            raw_n = torch.where(verb & (i < T), ebits, torch.where(run & esc, esc_bits, 0))
            val = torch.where(raw_n > 0, ln.take(raw_n, signed=True), val)
        res[:, i] = val

    # prediction: x[i] = res[i] + (sum_j coef[j] x[i-1-j]) >> shift
    x = torch.zeros((L, maxord + Tmax), dtype=_I64, device=dev)
    body = x[:, maxord:]
    if not maxord:
        body = res
    else:
        rev = torch.flip(coef[:, :maxord], dims=[1])  # rev[:, m] multiplies x[i-maxord+m]
        for j in range(maxord):
            body[:, j] = torch.where(coded & (j < order), warm[:, j], 0)
        for i in range(int(order.min()) if L else 0, Tmax):
            pred = (x[:, i:i + maxord] * rev).sum(1) >> shift
            step = coded & (i >= order) & (i < T)
            body[:, i] = torch.where(step, res[:, i] + pred, body[:, i])
    out = torch.where(coded[:, None], body, res)
    out = torch.where(const[:, None], cval[:, None], out)
    return out << wasted[:, None]


def _decode_block(W: torch.Tensor, B: torch.Tensor, lanes: dict, bits: int,
                  channels: int, end_bits: torch.Tensor) -> dict:
    """Decode one block of candidate lanes (their header already read on
    the host): PCM, the frame's end byte, CRC-16 and soundness a lane."""
    dev = W.device
    T = torch.as_tensor(lanes["blocksize"], dtype=_I64, device=dev)
    assign = torch.as_tensor(lanes["assignment"], dtype=_I64, device=dev)
    start = torch.as_tensor(lanes["start"], dtype=_I64, device=dev)
    ln = _Lanes(W, (start + torch.as_tensor(lanes["header"], dtype=_I64, device=dev)) * 8,
                end_bits)
    Tmax = int(lanes["blocksize"].max())
    chans = []
    for ch in range(channels):
        side = (((assign == 8) | (assign == 10)) & (ch == 1)) | ((assign == 9) & (ch == 0))
        chans.append(_subframe(ln, ~ln.bad, T, bits + side.to(_I64), Tmax))
    if channels == 2:
        a, b = chans
        mode = assign[:, None]
        left = torch.where(mode == 9, a + b, a)
        right = torch.where(mode == 8, a - b, b)
        mid = (a << 1) | (b & 1)
        ms = mode == 10
        left = torch.where(ms, (mid + b) >> 1, left)
        right = torch.where(ms, (mid - b) >> 1, right)
        chans = [left, right]
    pcm = torch.stack(chans, dim=-1)
    # zero bits up to the byte boundary, then the CRC-16
    ln.bad |= ln.take((-ln.pos) % 8) != 0
    stored = ln.take(16)
    end = ln.pos >> 3
    ln.bad |= ln.pos > end_bits
    ok = ~ln.bad
    crc_ok = crc.crc16_rows(B, start, torch.where(ok, end - 2 - start, 0)) == stored
    return dict(pcm=pcm.to(torch.int32).cpu().numpy(), end=end.cpu().numpy(),
                ok=ok.cpu().numpy(), crc_ok=crc_ok.cpu().numpy())


def decode_streams(streams: list[bytes], device: str | torch.device = "cpu") -> list[Decoded]:
    """Decode each stream on `device` and report what it holds."""
    device = torch.device(device)
    infos, metas = [], []
    for data in streams:
        si, audio = parse_metadata(data)
        metas.append((si, audio))
    # one buffer of every stream, each padded to whole words plus two
    bases, parts, at = [], [], 0
    for data in streams:
        bases.append(at)
        padded = len(data) + (-len(data)) % 4 + 8
        parts.append(np.frombuffer(data, np.uint8))
        parts.append(np.zeros(padded - len(data), np.uint8))
        at += padded
    buf = np.concatenate(parts) if parts else np.zeros(8, np.uint8)
    W = torch.as_tensor(buf.view(">u4").astype(np.int64), device=device)
    B = torch.as_tensor(buf.astype(np.int64), device=device)
    per_stream = []
    lanes = {k: [] for k in ("start", "header", "blocksize", "assignment", "number",
                             "stream", "local")}
    for s, (data, (si, audio)) in enumerate(zip(streams, metas)):
        h = _headers(np.frombuffer(data, np.uint8), audio, si)
        for key in ("header", "blocksize", "assignment", "number"):
            lanes[key].append(h[key])
        lanes["start"].append(h["start"] + bases[s])
        lanes["local"].append(h["start"])
        lanes["stream"].append(np.full(len(h["start"]), s))
        per_stream.append(len(h["start"]))
    lanes = {k: np.concatenate(v).astype(np.int64) if v else np.zeros(0, np.int64)
             for k, v in lanes.items()}
    out = {k: [] for k in ("pcm", "end", "ok", "crc_ok")}
    # lanes of one sample width and channel count share a block
    kinds = sorted({(m[0].bits_per_sample, m[0].channels) for m in metas})
    order = []
    for bits, channels in kinds:
        idx = np.flatnonzero([(metas[s][0].bits_per_sample, metas[s][0].channels)
                              == (bits, channels) for s in lanes["stream"]])
        for b0 in range(0, len(idx), LANES_PER_BLOCK):
            sel = idx[b0:b0 + LANES_PER_BLOCK]
            block = {k: v[sel] for k, v in lanes.items()}
            ends = np.asarray([bases[s] + len(streams[s]) for s in block["stream"]]) * 8
            r = _decode_block(W, B, block, bits, channels,
                              torch.as_tensor(ends, dtype=_I64, device=device))
            for k in out:
                out[k].append(list(r[k]))
            order.extend(sel.tolist())
    got = {k: [x for part in v for x in part] for k, v in out.items()}
    by_lane = {lane: i for i, lane in enumerate(order)}
    return [_chain(s, data, metas[s], lanes, got, by_lane, bases[s])
            for s, data in enumerate(streams)]


def _chain(s: int, data: bytes, meta, lanes: dict, got: dict, by_lane: dict,
           base: int) -> Decoded:
    """The stream's frames: from the first audio byte, each frame where the
    one before ended, numbered in turn."""
    si, audio = meta
    mine = np.flatnonzero(lanes["stream"] == s)
    at_byte = {int(lanes["local"][i]): int(i) for i in mine}
    errors, pcm, sizes = [], [], []
    pos, number = audio, 0
    while pos < len(data):
        lane = at_byte.get(pos)
        if lane is None:
            errors.append(f"no frame header with a sound CRC-8 at byte {pos}")
            break
        r = by_lane[lane]
        end = int(got["end"][r]) - base
        if lanes["number"][lane] != number:
            errors.append(f"frame {number} carries the number {int(lanes['number'][lane])}")
        if not got["ok"][r]:
            errors.append(f"frame {number} at byte {pos} does not decode")
            break
        if not got["crc_ok"][r]:
            errors.append(f"frame {number} at byte {pos}: CRC-16 mismatch")
        pcm.append(got["pcm"][r][:int(lanes["blocksize"][lane]), :si.channels])
        sizes.append(end - pos)
        pos, number = end, number + 1
    out = (np.concatenate(pcm) if pcm else np.zeros((0, si.channels), np.int32))
    return Decoded(si, out, np.asarray(sizes, np.int64), errors)
