"""Batched frame decoder, in PyTorch — the port of
flac_tpu.decode.frame_decoder.

Decodes B equal-geometry frames at once: the reference's bit-serial reader
loops (bitreader.c:775 Rice block read, stream_decoder.c:1996-2776 frame and
subframe parsing) become batched bit-window reads over one flat word array.
The frame header is read by eager tensor ops over the batch; each subframe
is two hand-written CUDA kernels on a GPU:

- the subframe scan (`subframe_scan_kernel`, csrc/residual_scan.cu): the
  subframe-header parse and the residual/verbatim window scan in one launch
  per channel, the port of `_decode_subframe`'s parse and
  `_narrow_residual_scan`;
- the fixed/LPC restore (`restore_scan_kernel`, csrc/restore_scan.cu), the
  port of `_restore_scan`, one launch over every channel's rows.

The scan has two forms, as in flac_tpu (`_use_narrow_scan`): the narrow one
(8 int32 limbs) for streams of at most 26 bits, and the wide one (4 int64
limbs, `_decode_subframe`'s wide branch) for wider streams or on request;
both are instantiations of the same kernel.

Each has a plain PyTorch version here (`subframe_scan`, the composition of
`read_subframe_header` and `narrow_residual_scan` or `wide_residual_scan`;
`restore_scan`), which CPU tensors take and which the tests hold against
flac_tpu. Frames the scan flags (`unary_overflow`) and variable-geometry
frames (the stream's final partial frame) are the host decoder's; the
stream layer (decode.stream) routes them there. Variable-blocksize streams
decode in groups of one blocksize, with each frame's header width given
(`dynamic_header_ext`).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from flac_tpu_torch.device import resolve_device
from flac_tpu_torch.dsp.signal import undo_channel_assignment
from flac_tpu_torch.encode.frame_encoder import _header_static_codes
from flac_tpu_torch.kernels import residual_scan as _residual_scan
from flac_tpu_torch.kernels import restore_scan as _restore_scan

_I32, _I64 = torch.int32, torch.int64
_MASK32 = 0xFFFFFFFF

# fixed-predictor restore coefficients (decoder view): x[t] = res[t] + sum c_j x[t-j]
_FIXED_COEFFS = np.array([
    [0, 0, 0, 0],
    [1, 0, 0, 0],
    [2, -1, 0, 0],
    [3, -3, 1, 0],
    [4, -6, 4, -1],
], np.int32)


@dataclass(frozen=True)
class DecoderGeometry:
    """Static frame geometry shared by a batch (from STREAMINFO + header
    codes). A copy of flac_tpu's, plus `from_dict`."""

    blocksize: int
    channels: int
    bits_per_sample: int
    sample_rate: int
    max_lpc_order: int = 32
    check_assignment: bool = True
    # "narrow" (8 int32 limbs), "wide" (4 int64 limbs) or "auto", which
    # obeys FLAC_TPU_SCAN=narrow|wide and defaults to narrow; streams of
    # more than 26 bits always take the wide scan
    scan_impl: str = "auto"
    # variable-blocksize streams: the decode fn takes a third argument,
    # hdr_ext_bits [B], each frame's bits between the UTF-8 number and the
    # CRC-8, in place of the static width (stream_decoder.c:2197-2225)
    dynamic_header_ext: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "DecoderGeometry":
        """Build from `dataclasses.asdict` of a flac_tpu DecoderGeometry."""
        return cls(**d)

    @property
    def header_ext_bits(self) -> int:
        """Static blocksize/sample-rate extension widths in the frame header."""
        cfg = _HeaderCfg(self.sample_rate, self.bits_per_sample)
        (_bs, bs_ext, _bv, _sr, sr_ext, _sv, _bc) = _header_static_codes(cfg, self.blocksize)
        return bs_ext + sr_ext


@dataclass(frozen=True)
class _HeaderCfg:
    """The two fields of EncoderConfig that _header_static_codes reads."""

    sample_rate: int
    bits_per_sample: int


def _use_narrow_scan(geom: DecoderGeometry) -> bool:
    """flac_tpu's rule: the int32-limb scan serves streams of at most 26
    bits (so verbatim and escaped widths stay <= 31 bits); then
    `scan_impl`, then FLAC_TPU_SCAN=narrow|wide; else narrow."""
    if geom.bits_per_sample > 26:
        return False
    if geom.scan_impl in ("narrow", "wide"):
        return geom.scan_impl == "narrow"
    forced = os.environ.get("FLAC_TPU_SCAN")
    if forced in ("narrow", "wide"):
        return forced == "narrow"
    return True


# ---------------------------------------------------------------------------
# bit reads over a flat word array (words: [W] int32, big-endian bit order;
# positions int64). uint32 values are held in int64 with explicit masks:
# torch has no uint32 shifts.
# ---------------------------------------------------------------------------


def _word_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """The word flac_tpu's `words[jnp.minimum(i, n - 1)]` reads: a negative
    index wraps once (i + n), is cut to int32, then clamped to [0, n - 1]
    (JAX's gather). Corrupt subframes reach negative bit positions."""
    j = torch.clamp(i, max=n - 1)
    return torch.clamp(_wrap32(torch.where(j < 0, j + n, j)), 0, n - 1)


def _peek32(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Next 32 bits at bit position `pos`, MSB-aligned, as int64 in [0, 2^32)."""
    wi = pos >> 5
    off = pos & 31
    n = words.shape[0]
    w0 = words[_word_index(wi, n)].to(_I64) & _MASK32
    w1 = words[_word_index(wi + 1, n)].to(_I64) & _MASK32
    return torch.where(off > 0, ((w0 << off) | (w1 >> (32 - off))) & _MASK32, w0)


def _as64(n, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(n, dtype=_I64, device=like.device)


def _read_bits(words, pos, n):
    """Read `n` (<= 32, an int or a per-lane tensor, may be 0) bits."""
    top = _peek32(words, pos)
    n64 = _as64(n, pos)
    val = torch.where(n64 > 0, top >> (32 - n64), 0)
    return val, pos + n64


def _sign_extend(v, n):
    n64 = _as64(n, v)
    one = torch.ones((), dtype=_I64, device=v.device)
    half = torch.where(n64 > 0, one << torch.clamp(n64 - 1, min=0), 0)
    return torch.where((n64 > 0) & (v >= half), v - (one << n64), v)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (32 for 0): a five-step
    binary search on masks (torch has no clz)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_zero = (x >> (32 - s)) == 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, (x << s) & _MASK32, x)
    return torch.where(x == 0, 32, n)


def _read_unary(words, pos):
    """Batched unary read: count zero bits to the stop bit (can exceed 32).
    Bounded at the end of the word buffer: a lane that runs into the zero
    padding past the stream stops there (the caller's frame-length check
    flags it). flac_tpu's `lax.while_loop` runs on the device; here it is a
    Python loop that syncs once a round (it usually takes one), which only
    CPU tensors take: on a GPU the subframe-scan kernel reads the run
    itself."""
    limit = words.shape[0] * 32
    q = torch.zeros_like(pos)
    done = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    p = pos
    while True:
        top = _peek32(words, p)
        z = _clz32(top)
        found = top != 0
        q = q + torch.where(done, 0, torch.where(found, z, 32))
        p = p + torch.where(done, 0, torch.where(found, z + 1, 32))
        done = done | found | (p >= limit)
        if bool(done.all()):
            return q, p


def _se32(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Sign-extend the low n (<= 31, may be 0) bits of v (< 2^n), as
    flac_tpu's int32 shift pair does."""
    one = torch.ones((), dtype=_I64, device=v.device)
    nn = torch.clamp(n, min=1)
    neg = (n > 0) & (v >= (one << (nn - 1)))
    return torch.where(neg, v - (one << nn), v)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits (two's complement)."""
    return ((x + 2 ** 31) & _MASK32) - 2 ** 31


# ---------------------------------------------------------------------------
# the residual/verbatim window scan
# ---------------------------------------------------------------------------

SCAN_U = 4       # samples per scan step
SCAN_NLOAD = 3   # word refills per step
SCAN_LIMBS = 8   # 32-bit limbs of the carried 256-bit window


def narrow_residual_scan(words, pos, T, is_coded, is_verb, ebps, order,
                         plen, pesc, ps):
    """The plain PyTorch residual/verbatim scan, step for step flac_tpu's
    `_narrow_residual_scan`: U=4 samples a step from a 256-bit window of 8
    uint32 limbs carried across steps, one window slide per sample, up to
    3 word refills per step. All values are int32 arithmetic (held in
    int64, wrapped where int32 wraps); the bit position is int64.

    `ovf` raises (and the frame goes to the host decoder) on a unary run of
    48 zeros or more, a Rice fold q * 2^k >= 2^30, or a step that spends
    more bits than its window held.

    words [W] int32; pos [B] int64 (bit position of the first residual
    field); T static; is_coded, is_verb [B] bool; ebps, order, plen, pesc,
    ps [B] int. Returns (res [B, T] int32, pos [B] int64, ovf [B] bool).
    """
    dev = pos.device
    n = words.shape[0]
    L = SCAN_LIMBS
    limb = torch.arange(L, device=dev)

    def gw(i):
        return words[_word_index(i, n)].to(_I64) & _MASK32

    def funnel(a, b, r):
        """Bits [r, r+32) of the 64-bit a:b, r in [0, 32)."""
        return torch.where(r > 0, ((a << r) | (b >> ((32 - r) & 31))) & _MASK32, a)

    ebps, order, plen, pesc, ps = (_wrap32(x.to(_I64)) for x in
                                   (ebps, order, plen, pesc, ps))
    pos = pos.to(_I64)
    wi0 = _wrap32(pos >> 5)
    off = _wrap32(pos & 31)
    a = torch.stack([gw(wi0 + j) for j in range(L + 1)], dim=1)   # [B, 9]
    win = funnel(a[:, :L], a[:, 1:], off[:, None])                 # [B, 8]
    navail = 256 - off
    wpos = wi0 + L
    zero = torch.zeros_like(pos)
    k, rawlen, ovf = zero, zero, zero != 0
    # t mod 0 is 0, as flac_tpu's jnp.mod gives it (so a zero partition
    # size, possible on corrupt headers, reads a parameter every sample)
    ps_safe = torch.where(ps == 0, 1, ps)
    outs = []
    for t0 in range(0, T, SCAN_U):
        spent = zero
        for t in range(t0, min(t0 + SCAN_U, T)):
            w0, w1, w2 = win[:, 0], win[:, 1], win[:, 2]
            boundary = is_coded & (t % ps_safe == 0)
            # partition parameter: always at window offset 0
            nb = torch.where(boundary, plen, 0)
            pv = torch.where(nb > 0, w0 >> ((32 - nb) & 31), 0)
            k = torch.where(boundary, pv, k)
            o = nb
            # escape: 5-bit raw bit-length at offset <= 5
            isesc_b = boundary & (k == pesc)
            nb2 = torch.where(isesc_b, 5, 0)
            rl = torch.where(nb2 > 0, funnel(w0, w1, o) >> 27, 0)
            rawlen = torch.where(isesc_b, rl, rawlen)
            o = o + nb2
            esc = k == pesc
            in_res = is_coded & (t >= order)
            rice_on = in_res & ~esc
            # unary run: clz over the 64 bits at offset o (o <= 10)
            u1 = funnel(w0, w1, o)
            u2 = funnel(w1, w2, o)
            z = torch.where(u1 != 0, _clz32(u1), 32 + _clz32(u2))
            z = torch.where((u1 == 0) & (u2 == 0), 64, z)
            ovf = ovf | (rice_on & (z >= 48))
            q = torch.where(rice_on, torch.clamp(z, max=47), 0)
            o = o + torch.where(rice_on, q + 1, 0)
            # int32 fold guard: q * 2^k must stay below 2^30
            kk = torch.clamp(k, 0, 31)
            lim = (torch.ones_like(kk) << torch.clamp(30 - kk, min=0)) - 1
            ovf = ovf | (rice_on & (q > lim))
            # Rice LSBs: kk bits at offset o (o <= 58 -> limb 0 or 1)
            nbk = torch.where(rice_on, kk, 0)
            r_u = o & 31
            top_k = torch.where(o >= 32, funnel(w1, w2, r_u), funnel(w0, w1, r_u))
            lsb = torch.where(nbk > 0, top_k >> ((32 - nbk) & 31), 0)
            o = o + nbk
            folded = _wrap32((q << kk) | lsb)
            rice_val = (folded >> 1) ^ -(folded & 1)
            # escaped raw bits: rawlen (<= 31) bits at offset <= 10
            nbr = torch.where(in_res & esc, rawlen, 0)
            top_r = funnel(w0, w1, o & 31)
            rvu = torch.where(nbr > 0, top_r >> ((32 - nbr) & 31), 0)
            raw_val = _se32(rvu, nbr)
            o = o + nbr
            # verbatim: ebps bits at offset 0 (no partition on verbatim)
            nbv = torch.where(is_verb, ebps, 0)
            vv = torch.where(nbv > 0, w0 >> ((32 - nbv) & 31), 0)
            verb_val = _se32(vv, nbv)
            o = o + nbv
            outs.append(torch.where(rice_on, rice_val,
                        torch.where(in_res & esc, raw_val,
                        torch.where(is_verb, verb_val, 0))))
            # one window slide by o (<= 88 bits): limb i takes the funnel of
            # limbs (i + j, i + j + 1), j = o >> 5 in {0, 1, else 2}
            j = torch.where((o >> 5) == 0, 0, torch.where((o >> 5) == 1, 1, 2))
            ext = torch.nn.functional.pad(win, (0, 3))
            src = (limb[None, :] + j[:, None])
            win = funnel(torch.gather(ext, 1, src), torch.gather(ext, 1, src + 1),
                         (o & 31)[:, None])
            spent = spent + o
        # all consumed bits must have been inside the valid window
        ovf = ovf | (spent > navail)
        navail = torch.clamp(navail - spent, min=0)
        # refill: insert up to NLOAD words at bit offset `navail`
        for _ in range(SCAN_NLOAD):
            can = navail <= 256 - 32
            wv = gw(wpos)
            jw = navail >> 5
            rw = navail & 31
            p0 = wv >> rw
            p1 = torch.where(rw > 0, (wv << ((32 - rw) & 31)) & _MASK32, 0)
            at = can[:, None] & (jw[:, None] == limb[None, :])
            at1 = can[:, None] & (jw[:, None] + 1 == limb[None, :])
            win = win | torch.where(at, p0[:, None], 0) | torch.where(at1, p1[:, None], 0)
            navail = navail + torch.where(can, 32, 0)
            wpos = wpos + torch.where(can, 1, 0)
        pos = pos + spent
    res = torch.stack(outs, dim=1).to(_I32)
    return res, pos, ovf


WIDE_LIMBS = 4   # 64-bit limbs of the wide scan's 256-bit window


def _srl64(a: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by n in [0, 63] (torch's
    >> is arithmetic): the arithmetic shift with the sign copies masked."""
    n = torch.as_tensor(n, dtype=_I64, device=a.device)
    one = torch.ones((), dtype=_I64, device=a.device)
    return (a >> n) & (((one << (63 - n)) << 1) - 1)


def wide_residual_scan(words, pos, T, is_coded, is_verb, ebps, order,
                       plen, pesc, ps):
    """The plain PyTorch wide residual/verbatim scan, step for step
    flac_tpu's wide branch of `_decode_subframe` (frame_decoder.py:484-595):
    U=4 samples a step from a 256-bit window of four 64-bit limbs carried
    across steps (held as int64 bit patterns), each field read by one
    `take(n)` (n <= 63 bits) that slides the window, up to 3 word refills
    at the end of each step. Values are int64, so verbatim samples of up to
    33 bits and Rice folds up to 47 * 2^30 come out whole.

    `ovf` raises (the frame goes to the host decoder) on a unary run of 48
    zeros or more, or a step that spends more bits than its window held.

    The arguments are narrow_residual_scan's. Returns (res [B, T] int64,
    pos [B] int64, ovf [B] bool).
    """
    dev = pos.device
    n = words.shape[0]
    L = WIDE_LIMBS
    limb = torch.arange(L, device=dev)

    def gw(i):
        return words[_word_index(i, n)].to(_I64) & _MASK32

    ebps, order, plen, pesc, ps = (x.to(_I64) for x in (ebps, order, plen, pesc, ps))
    pos = pos.to(_I64)
    wi0 = pos >> 5
    off0 = pos & 31
    a = torch.stack([(gw(wi0 + 2 * j) << 32) | gw(wi0 + 2 * j + 1) for j in range(L)]
                    + [torch.zeros_like(pos)], dim=1)                # [B, 5]
    offc = torch.clamp(off0, min=1)[:, None]
    win = torch.where(off0[:, None] > 0,
                      (a[:, :L] << offc) | _srl64(a[:, 1:], 64 - offc), a[:, :L])
    navail = 256 - off0
    wpos = wi0 + 8
    zero = torch.zeros_like(pos)
    k, rawlen, ovf = zero, zero, zero != 0
    # t mod 0 is 0, as flac_tpu's jnp.mod gives it
    ps_safe = torch.where(ps == 0, 1, ps)

    def take(win, nbits):
        """(the next nbits (<= 63; <= 0 reads 0) bits, the slid window)."""
        on = nbits > 0
        nn = torch.clamp(nbits, 1, 63)
        nxt = torch.nn.functional.pad(win[:, 1:], (0, 1))
        slid = (win << nn[:, None]) | _srl64(nxt, 64 - nn[:, None])
        return (torch.where(on, _srl64(win[:, 0], 64 - nn), 0),
                torch.where(on[:, None], slid, win))

    outs = []
    for t0 in range(0, T, SCAN_U):
        spent = zero
        for t in range(t0, min(t0 + SCAN_U, T)):
            boundary = is_coded & (t % ps_safe == 0)
            nb = torch.where(boundary, plen, 0)
            pv, win = take(win, nb)
            k = torch.where(boundary, pv, k)
            isesc_b = boundary & (k == pesc)
            nb2 = torch.where(isesc_b, 5, 0)
            rl, win = take(win, nb2)
            rawlen = torch.where(isesc_b, rl, rawlen)
            esc = k == pesc
            in_res = is_coded & (t >= order)
            rice_on = in_res & ~esc
            l0 = win[:, 0]
            hi = _srl64(l0, 32)
            z = torch.where(hi != 0, _clz32(hi), 32 + _clz32(l0 & _MASK32))
            z = torch.where(l0 == 0, 64, z)
            ovf = ovf | (rice_on & (z >= 48))
            q = torch.where(rice_on, torch.clamp(z, max=47), 0)
            nq = torch.where(rice_on, q + 1, 0)
            _, win = take(win, nq)
            nk = torch.where(rice_on, k, 0)
            lsb, win = take(win, nk)
            folded = (q << torch.clamp(k, min=0)) | lsb
            rice_val = (folded >> 1) ^ -(folded & 1)
            nr = torch.where(in_res & esc, rawlen, 0)
            rv, win = take(win, nr)
            nv = torch.where(is_verb, ebps, 0)
            vv, win = take(win, nv)
            outs.append(torch.where(rice_on, rice_val,
                        torch.where(in_res & esc, _sign_extend(rv, nr),
                        torch.where(is_verb, _sign_extend(vv, nv), 0))))
            spent = spent + nb + nb2 + nq + nk + nr + nv
        # all consumed bits must have been inside the valid window
        ovf = ovf | (spent > navail)
        navail = torch.clamp(navail - spent, min=0)
        # refill: insert up to 3 words at bit offset `navail`; limb j takes
        # the word's top bits, limb j + 1 the rest
        for _ in range(SCAN_NLOAD):
            can = navail <= 256 - 32
            wv = gw(wpos)
            j = navail >> 6
            q = navail & 63
            part0 = torch.where(q <= 32, wv << torch.clamp(32 - q, 0, 63),
                                _srl64(wv, torch.clamp(q - 32, 0, 63)))
            part1 = torch.where(q > 32, wv << torch.clamp(96 - q, 33, 63), 0)
            at0 = can[:, None] & (j[:, None] == limb[None, :])
            at1 = can[:, None] & (j[:, None] + 1 == limb[None, :])
            win = (win | torch.where(at0, part0[:, None], 0)
                   | torch.where(at1, part1[:, None], 0))
            navail = navail + torch.where(can, 32, 0)
            wpos = wpos + torch.where(can, 1, 0)
        pos = pos + spent
    return torch.stack(outs, dim=1), pos, ovf


# ---------------------------------------------------------------------------
# the fixed/LPC restore
# ---------------------------------------------------------------------------


def restore_scan(res, coeffs, order, shift, warm, is_coded, T, maxord):
    """The plain PyTorch restore, flac_tpu's `_restore_scan`: for t < order
    x[t] = warm[t]; then x[t] = res[t] + ((sum_j c_j x[t-1-j]) >> shift),
    int64 throughout; frames that are not coded give 0.

    res [B, T] int32 (the narrow scan's) or int64 (the wide scan's);
    coeffs, warm [B, maxord] int64; order, shift [B] int64; is_coded [B]
    bool. Returns x [B, T] int64."""
    B = res.shape[0]
    dev = res.device
    jgrid = torch.arange(maxord, device=dev)
    cm = torch.where(jgrid[None, :] < order[:, None], coeffs.to(_I64), 0)
    cm_rev = cm.flip(1)      # column maxord-1-j multiplies x[t-1-j]
    # x[t] lives at column maxord + t; the zero columns before it stand for
    # the zero history the scan starts from
    xbuf = torch.zeros((B, maxord + T), dtype=_I64, device=dev)
    for t in range(T):
        pred = (cm_rev * xbuf[:, t:t + maxord]).sum(dim=1) >> shift
        w_t = warm[:, t] if t < maxord else 0
        xbuf[:, maxord + t] = torch.where(
            is_coded, torch.where(t < order, w_t, res[:, t] + pred), 0)
    return xbuf[:, maxord:]


def restore_scan_kernel(res, coeffs, order, shift, warm, is_coded, T, maxord):
    """restore_scan with the recurrence done by the hand-written CUDA kernel
    (kernels.restore_scan) — the counterpart of flac_tpu's `_restore_scan`.
    CUDA tensors launch the kernel (a failure raises); CPU tensors take the
    plain version."""
    if res.device.type == "cpu":
        return restore_scan(res, coeffs, order, shift, warm, is_coded, T, maxord)
    return _restore_scan.restore_scan(res, coeffs, order, shift, warm, is_coded,
                                      T, maxord)


# ---------------------------------------------------------------------------
# the frame decoder
# ---------------------------------------------------------------------------


def read_frame_header(words, pos, ext_bits, channels: int):
    """The frame header at `pos`, whose blocksize and sample-rate fields
    take `ext_bits` bits after the UTF-8 number (an int for the whole
    batch, or a [B] tensor of each frame's): (pos after the CRC-8,
    assignment [B] int32 (0 independent, 1 left/side, 2 right/side, 3
    mid/side), sync_ok [B] bool)."""
    h, pos = _read_bits(words, pos, 32)
    ca_code = (h >> 4) & 15
    sync_ok = (h >> 18) == 0x3FFE
    lead, _ = _read_bits(words, pos, 8)
    utf8_len = 1 + sum((lead >= b).to(_I64)
                       for b in (0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE))
    pos = pos + 8 * utf8_len + ext_bits + 8  # number + ext fields + CRC-8
    if channels == 2:
        assignment = torch.where(ca_code == 8, 1, torch.where(
            ca_code == 9, 2, torch.where(ca_code == 10, 3, 0))).to(_I32)
    else:
        assignment = torch.zeros(pos.shape, dtype=_I32, device=pos.device)
    return pos, assignment, sync_ok


def side_channel_bps(assignment, c: int, bps: int, channels: int):
    """Channel c's sample width: the side channel carries one extra bit
    (stream_decoder.c:2022)."""
    cbps = torch.full(assignment.shape, bps, dtype=_I64, device=assignment.device)
    if channels == 2:
        is_side = (((assignment == 1) & (c == 1)) | ((assignment == 2) & (c == 0))
                   | ((assignment == 3) & (c == 1)))
        cbps = cbps + is_side.to(_I64)
    return cbps


def read_subframe_header(words, pos, cbps, T: int, maxord: int) -> dict:
    """Everything of a subframe before its samples: type, wasted bits,
    constant value, warmup, LPC precision/shift/coefficients and the entropy
    coding header. Returns a dict of [B] (or [B, maxord]) tensors, with
    `pos` at the first residual (or verbatim) bit."""
    B = pos.shape[0]
    dev = pos.device
    hdr, pos = _read_bits(words, pos, 8)
    stype = (hdr >> 1) & 0x3F
    wflag = hdr & 1
    wq, pos_w = _read_unary(words, pos)
    wasted = torch.where(wflag == 1, wq + 1, 0)
    pos = torch.where(wflag == 1, pos_w, pos)
    ebps = cbps - wasted

    is_const = stype == 0
    is_verb = stype == 1
    is_fixed = (stype >> 3) == 1
    is_lpc = (stype >> 5) == 1
    is_coded = is_fixed | is_lpc
    order = torch.where(is_fixed, stype & 7,
                        torch.where(is_lpc, (stype & 31) + 1, 0)).to(_I64)

    nconst = torch.where(is_const, ebps, 0)
    cval_raw, pos = _read_bits(words, pos, nconst)
    cval = _sign_extend(cval_raw, nconst)

    warm = torch.zeros((B, maxord), dtype=_I64, device=dev)
    for j in range(maxord):
        nbits = torch.where(is_coded & (j < order), ebps, 0)
        v, pos = _read_bits(words, pos, nbits)
        warm[:, j] = _sign_extend(v, nbits)

    pv, pos = _read_bits(words, pos, torch.where(is_lpc, 4, 0))
    prec = torch.where(is_lpc, pv + 1, 0)
    nshift = torch.where(is_lpc, 5, 0)
    sv, pos = _read_bits(words, pos, nshift)
    shift = _sign_extend(sv, nshift)
    qlp = torch.zeros((B, maxord), dtype=_I64, device=dev)
    for j in range(maxord):
        nbits = torch.where(is_lpc & (j < order), prec, 0)
        v, pos = _read_bits(words, pos, nbits)
        qlp[:, j] = _sign_extend(v, nbits)

    ev, pos = _read_bits(words, pos, torch.where(is_coded, 6, 0))
    method = (ev >> 4) & 3
    po = ev & 15
    return dict(
        pos=pos, is_const=is_const, is_verb=is_verb, is_fixed=is_fixed,
        is_lpc=is_lpc, is_coded=is_coded, order=order, wasted=wasted,
        ebps=ebps, cval=cval, warm=warm, shift=shift, qlp=qlp,
        plen=torch.where(method == 1, 5, 4).to(_I64),
        pesc=torch.where(method == 1, 31, 15).to(_I64),
        ps=torch.where(is_coded, torch.full_like(po, T) >> po, T).to(_I64))


def restore_inputs(sub: dict, maxord: int):
    """(coeffs [B, maxord] int64, order, shift [B] int64, warm, is_coded) of
    the restore: fixed orders use binomial coefficients with shift 0."""
    B = sub["order"].shape[0]
    dev = sub["order"].device
    coeffs = torch.where(sub["is_lpc"][:, None], sub["qlp"],
                         torch.zeros((B, maxord), dtype=_I64, device=dev))
    if maxord >= 4:
        fixed = torch.as_tensor(_FIXED_COEFFS, dtype=_I64, device=dev)
        fixed_c = fixed[torch.clamp(sub["order"], 0, 4)]
        coeffs = torch.where(sub["is_fixed"][:, None],
                             torch.nn.functional.pad(fixed_c, (0, maxord - 4)), coeffs)
    rshift = torch.where(sub["is_lpc"], torch.clamp(sub["shift"], min=0), 0)
    return coeffs, sub["order"], rshift, sub["warm"], sub["is_coded"]


def subframe_scan(words, pos, cbps, T: int, maxord: int, wide: bool = False):
    """The plain subframe scan of every frame: `read_subframe_header` at
    `pos`, then `narrow_residual_scan` (or, `wide`, `wide_residual_scan`)
    from the header's end. Returns (sub, res [B, T] (int32 narrow, int64
    wide), pos [B] int64 after the samples, ovf [B] bool); `sub` is
    read_subframe_header's dict."""
    sub = read_subframe_header(words, pos, cbps, T, maxord)
    scan = wide_residual_scan if wide else narrow_residual_scan
    res, pos, ovf = scan(
        words, sub["pos"], T, sub["is_coded"], sub["is_verb"], sub["ebps"],
        sub["order"], sub["plen"], sub["pesc"], sub["ps"])
    return sub, res, pos, ovf


def subframe_scan_kernel(words, pos, cbps, T: int, maxord: int, wide: bool = False):
    """subframe_scan done by the hand-written CUDA kernel
    (kernels.residual_scan, its narrow or wide instantiation), which parses
    the subframe header and scans the samples in one launch — the
    counterpart of flac_tpu's `_decode_subframe` with
    `_narrow_residual_scan` or its wide branch. CUDA tensors launch the
    kernel (a failure raises); CPU tensors take the plain version."""
    if pos.device.type == "cpu":
        return subframe_scan(words, pos, cbps, T, maxord, wide)
    return _residual_scan.subframe_scan(words, pos, cbps, T, maxord, wide=wide)


def finish_subframe(sub: dict, res, x):
    """A channel's samples from its restore `x`: the constant and verbatim
    subframes replace it, then the wasted bits shift back in. Returns (x [B,
    T] int64, wasted, type (0 constant, 1 verbatim, 2 fixed, 3 LPC), order,
    all [B] int32)."""
    x = torch.where(sub["is_const"][:, None], sub["cval"][:, None], x)
    x = torch.where(sub["is_verb"][:, None], res.to(_I64), x)
    x = x << sub["wasted"][:, None]
    stype = torch.where(sub["is_const"], 0, torch.where(
        sub["is_verb"], 1, torch.where(sub["is_fixed"], 2, 3))).to(_I32)
    return x, sub["wasted"].to(_I32), stype, sub["order"].to(_I32)


def build_frame_decoder(geom: DecoderGeometry,
                        device: str | torch.device | None = None):
    """The decoder of a batch of frames of one geometry on `device` (None:
    CUDA, which raises without a GPU). Returns fn(words [W] int32, start_bits
    [B] int64[, hdr_ext_bits [B] with geom.dynamic_header_ext]) -> (pcm
    [B, T, Ch] (int16 for <= 16 bits, else int32),
    end_bits [B] int64, meta dict of sync_ok, assignment, subframe_type,
    order, wasted, unary_overflow); inputs may be numpy arrays or tensors,
    outputs are on the device. The scan choice (FLAC_TPU_SCAN) is read here,
    outside the build cache, so that a change takes effect."""
    device = resolve_device(device)
    return _build_frame_decoder(geom, device, not _use_narrow_scan(geom))


@functools.lru_cache(maxsize=64)
def _build_frame_decoder(geom: DecoderGeometry, device: torch.device, wide: bool):
    T = geom.blocksize
    Ch = geom.channels
    bps = geom.bits_per_sample
    maxord = geom.max_lpc_order
    ext_bits = geom.header_ext_bits
    out_dtype = torch.int16 if bps <= 16 else torch.int32

    def decode(words, start_bits, hdr_ext_bits=None):
        words = torch.as_tensor(words, dtype=_I32, device=device)
        pos = torch.as_tensor(start_bits, device=device).to(_I64)
        ext = (torch.as_tensor(hdr_ext_bits, device=device).to(_I64)
               if geom.dynamic_header_ext else ext_bits)
        pos, assignment, sync_ok = read_frame_header(words, pos, ext, Ch)
        # a channel's subframe starts where the previous one ends, so the
        # scans run in turn; the restore then runs once on all their rows
        subs, ress = [], []
        any_ovf = torch.zeros(pos.shape, dtype=torch.bool, device=device)
        for c in range(Ch):
            cbps = side_channel_bps(assignment, c, bps, Ch)
            sub, res, pos, ovf = subframe_scan_kernel(words, pos, cbps, T, maxord, wide)
            any_ovf = any_ovf | ovf
            subs.append(sub)
            ress.append(res)
        rin = [torch.cat(parts) for parts in
               zip(*(restore_inputs(sub, maxord) for sub in subs))]
        xs = restore_scan_kernel(torch.cat(ress), *rin, T, maxord).chunk(Ch)
        chans, wasteds, types, orders = zip(*(
            finish_subframe(sub, res, x) for sub, res, x in zip(subs, ress, xs)))
        # byte-align, then the frame's CRC-16 (checked by the stream layer)
        pos = ((pos + 7) & ~7) + 16
        if Ch == 2:
            pcm = torch.stack(undo_channel_assignment(*chans, assignment), dim=-1)
        else:
            pcm = torch.stack(chans, dim=-1)
        meta = dict(sync_ok=sync_ok, assignment=assignment,
                    subframe_type=torch.stack(types, dim=1),
                    order=torch.stack(orders, dim=1),
                    wasted=torch.stack(wasteds, dim=1),
                    unary_overflow=any_ovf)
        return pcm.to(out_dtype), pos, meta

    return decode


# ---------------------------------------------------------------------------


def bytes_to_words(data: bytes | np.ndarray, bucket: bool = False) -> np.ndarray:
    """Big-endian uint32 view of a byte stream (as int32), zero-padded by
    two words. `bucket=True` pads the word count up to the next power of
    two (at least 4096), as flac_tpu does to bound its compiles; the port
    keeps it so that reads past the stream stop at the same limit."""
    arr = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8).reshape(-1)
    pad = (-len(arr)) % 4
    arr = np.concatenate([arr, np.zeros(pad + 8 if pad else 8, np.uint8)])
    words = arr.view(">u4").astype(np.uint32).view(np.int32)
    if bucket:
        n = max(4096, 1 << (len(words) - 1).bit_length())
        if n > len(words):
            words = np.concatenate([words, np.zeros(n - len(words), np.int32)])
    return words


def byte_rows_to_words(rows: torch.Tensor) -> torch.Tensor:
    """bytes_to_words on the device: uint8 byte rows [N, R], back to back,
    as big-endian int32 words, zero-padded to a whole word plus two."""
    flat = rows.reshape(-1).to(_I64)
    pad = (-flat.numel()) % 4 + 8
    flat = torch.cat([flat, torch.zeros(pad, dtype=_I64, device=flat.device)]).view(-1, 4)
    w = (flat[:, 0] << 24) | (flat[:, 1] << 16) | (flat[:, 2] << 8) | flat[:, 3]
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(_I32)


def make_verifier(cfg, device: torch.device):
    """Verify-while-encoding (the reference's decoder-in-the-encoder,
    stream_encoder.c:977-1006): fn(rows) -> pcm [B, T, Ch] of the decoded
    frames, on the device, one packed frame a row. `rows` are int32 word
    rows [B, maxwords] (the padded layout) or uint8 byte rows [B, maxb]
    (flac_tpu's dense layout), on `device`; the rows are decoded where they
    lie, back to back, plus the zero words bytes_to_words appends."""
    geom = DecoderGeometry(blocksize=cfg.blocksize, channels=cfg.channels,
                           bits_per_sample=cfg.bits_per_sample,
                           sample_rate=cfg.sample_rate,
                           max_lpc_order=max(cfg.max_lpc_order, 4))
    dec = build_frame_decoder(geom, device)

    def verify(rows: torch.Tensor) -> torch.Tensor:
        B = rows.shape[0]
        if rows.dtype == torch.uint8:
            flat, row_bits = byte_rows_to_words(rows), rows.shape[1] * 8
        else:
            flat = torch.cat([rows.reshape(-1),
                              torch.zeros(2, dtype=_I32, device=rows.device)])
            row_bits = rows.shape[1] * 32
        starts = torch.arange(B, dtype=_I64, device=rows.device) * row_bits
        pcm, _end, _meta = dec(flat, starts)
        return pcm

    return verify
