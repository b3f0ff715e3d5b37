"""Parallel bitstream packing — the port of flac_tpu.encode.packer.

Every frame is a flat list of (value, nbits) fields; a prefix sum of nbits
gives each field's end bit; each field lands in at most 2 consecutive 32-bit
words, and the contributions are bit-disjoint. CRC-8 comes from the fields
and CRC-16 from the packed words as GF(2) reductions (see flac_tpu.crc).

The pack stage has two versions behind `pack_frames_kernel`: one launch of
the CUDA kernel (kernels.pack_words, csrc/pack_words.cu: prefix sum, word
fill and CRC-16) for CUDA tensors, and the plain PyTorch `pack_frames`
(`pack_fields`, `crc16_from_words`, `insert_crc16`) for CPU tensors.
`pack_fields_kernel` / `pack_fields` is the word fill alone. The merged
packer (`pack_fields_merged_kernel` / plain `pack_fields_merged`, or
`merged=True`) fills the same words from merged field quads; the frame
encoder packs with the banded fill. Field values MUST be pre-masked to
their nbits. The dense route's compaction of a batch's packed frames into
one word stream has the same two versions behind
`compact_stream_words_kernel`: one launch of csrc/compact_stream.cu for
CUDA tensors, the plain `compact_stream_words` for CPU tensors.

torch has no uint32 shifts and no XOR reduction, so the uint32 arithmetic
of flac_tpu runs here in int64 with explicit 32-bit masks, and XOR sums go
through a pairwise tree (exact in any order).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flac_tpu_torch import crc as crc_mod
from flac_tpu_torch.dsp.bitmath import tree_reduce
from flac_tpu_torch.kernels import compact_stream as _compact_stream
from flac_tpu_torch.kernels import pack_words as _pack_words

# Max significant bits in any field value: a RICE2 codeword has k+1 <= 31
# significant bits, a 32-bit verbatim/warmup sample 32, the side channel 33,
# the combined first header field 32.
MAX_SIG_BITS = 33

_MASK32 = 0xFFFFFFFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns (uint32 -> int32)."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


@functools.lru_cache(maxsize=8)
def xpow_table_np(maxbits: int, poly: int, width: int) -> np.ndarray:
    """Entry d = x^(d + width) mod G: CRC contribution of a set bit at
    bit-distance d from the end of the message."""
    return crc_mod.x_pow_mod_table(maxbits + width + 1, poly, width)[width:].astype(np.int32)


def crc_reduce(values: torch.Tensor, ends: torch.Tensor, msg_end: torch.Tensor,
               include: torch.Tensor, table: torch.Tensor, poly: int,
               width: int) -> torch.Tensor:
    """CRC of the concatenated fields [0, msg_end) as a pure XOR reduction.

    values [..., F] int64; ends [..., F] int32 field end bits; msg_end [...];
    include [..., F] bool. Returns [...] int64.
    """
    base = (msg_end[..., None] - ends).to(torch.int32)
    base = torch.clamp(base, 0, table.shape[0] - 1)
    tvals = table[base.long()].to(torch.int64)
    v = torch.where(include, values, 0)
    prod = torch.zeros_like(v)
    for b in range(width):  # carryless multiply by the table entry
        prod = prod ^ torch.where(((tvals >> b) & 1) == 1, v << b, 0)
    g_full = (1 << width) | poly
    for bit in range(MAX_SIG_BITS + width - 1, width - 1, -1):  # mod G
        prod = prod ^ (((prod >> bit) & 1) * (g_full << (bit - width)))
    return tree_reduce(prod, torch.bitwise_xor)


def _field_words(nbits: torch.Tensor):
    """ends (int32 inclusive prefix sum), total_bits, we (word of each
    field's last bit) and r (its bits in that word, in [1, 32])."""
    ends = torch.cumsum(nbits, dim=-1, dtype=torch.int32)
    we = (ends - 1) >> 5
    return ends, ends[..., -1], we, ends - (we << 5)


def pack_fields(values: torch.Tensor, nbits: torch.Tensor, maxwords: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch word fill: pack fields into big-endian 32-bit words.

    values [B, F] int64 (masked, <= MAX_SIG_BITS significant bits); nbits
    [B, F] int32. Returns (words [B, maxwords] int32 — serialize big-endian
    for the byte stream, total_bits [B] int32).

    Mirrors flac_tpu's segmented reduction without scatter: `we` is sorted,
    so word w's sum is a difference of running sums at the segment bounds,
    which torch.searchsorted finds (in place of flac_tpu's unrolled binary
    search). c1 contributions belong to word we-1.
    """
    ends, total_bits, we, r = _field_words(nbits)
    has = nbits > 0
    v = torch.where(has, values, 0)
    c0 = torch.where(has, (v << (32 - r)) & _MASK32, 0)
    # v >> r < 2^32 (<= 33 significant bits, r >= 1)
    c1 = (v >> r) & _MASK32
    B = values.shape[0]
    zero = torch.zeros((B, 1), dtype=torch.int64, device=values.device)
    S0p = torch.cat([zero, torch.cumsum(c0, dim=-1)], dim=-1)
    S1p = torch.cat([zero, torch.cumsum(c1, dim=-1)], dim=-1)
    w_probe = torch.arange(-1, maxwords + 1, dtype=torch.int32,
                           device=values.device).expand(B, maxwords + 2)
    # first index with we > w == count of fields with we <= w
    pos = torch.searchsorted(we.contiguous(), w_probe.contiguous(), right=True)
    t0 = torch.gather(S0p, 1, pos)
    t1 = torch.gather(S1p, 1, pos)
    words = (t0[:, 1:maxwords + 1] - t0[:, :maxwords]
             + t1[:, 2:maxwords + 2] - t1[:, 1:maxwords + 1])
    return to_int32_bits(words), total_bits


def pack_fields_kernel(values: torch.Tensor, nbits: torch.Tensor, maxwords: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """pack_fields done by the hand-written CUDA kernel (its fill-only mode,
    one launch, the prefix sum inside) — the counterpart of flac_tpu's
    pack_fields_pallas. CUDA tensors launch the kernel (a failure raises);
    CPU tensors take the plain version."""
    if values.device.type == "cpu":
        return pack_fields(values, nbits, maxwords)
    return _pack_words.pack_words(values.contiguous(), nbits.contiguous(), maxwords)


# ---------------------------------------------------------------------------
# Merged-field pack: two pairwise merge rounds turn
# F fields into F/4 merged slots of <= 63 significant bits plus two spill
# arrays, each slot with <= 3 word contributions (flac_tpu's
# pack_fields_pallas_merged). A pair (e1 < e2) merges into v1 << d | v2,
# d = e2 - e1, when sig1 + d <= 63; otherwise the right slot spills. The
# bits the spill slots own lie strictly inside [e1, e2), so the three
# arrays' contributions are bit-disjoint and their word images add (or OR)
# exactly. flac_tpu's tile bounds and nonzero bitmap only schedule a TPU
# grid; here a slot whose contributions are all 0 costs nothing.
# ---------------------------------------------------------------------------

MERGE_ROUNDS = 2


def _merge_round(v: torch.Tensor, e: torch.Tensor, sig: torch.Tensor):
    """One pairwise merge round. v int64, e int64, sig int32: [B, F], F
    even. Returns (merged (v, e, sig) [B, F/2], spill (v, e, sig) [B, F/2])."""
    vL, vR = v[:, 0::2], v[:, 1::2]
    eL, eR = e[:, 0::2], e[:, 1::2]
    sL, sR = sig[:, 0::2], sig[:, 1::2]
    d = (eR - eL).to(torch.int64)
    fit = (sL == 0) | ((sL.to(torch.int64) + d) <= 63)
    dc = torch.clamp(d, 0, 63)
    vM = torch.where(fit, torch.where(sL > 0, vL << dc, 0) | vR, vL)
    eM = torch.where(fit, eR, eL)
    sM = torch.where(fit, torch.where(sL > 0, sL + d.to(sig.dtype), sR), sL)
    vS = torch.where(fit, 0, vR)
    sS = torch.where(fit, 0, sR)
    return (vM, eM, sM), (vS, eR, sS)


def merged_slots(values: torch.Tensor, nbits: torch.Tensor):
    """The merge prep: ([(v int64, e int64) of spill round 1, spill round 2,
    merged], total_bits int32 [B]). Slot arrays are [B, F/2], [B, F/4],
    [B, F/4] (F rounded up to even at each round)."""
    ends = torch.cumsum(nbits, dim=-1, dtype=torch.int32)
    total_bits = ends[:, -1]
    v = torch.where(nbits > 0, values, 0).to(torch.int64)
    e = ends.to(torch.int64)
    sig = torch.clamp(nbits, max=MAX_SIG_BITS).to(torch.int32)
    arrays = []
    for _ in range(MERGE_ROUNDS):
        if v.shape[1] % 2:  # pad: an empty slot ending where the last one ends
            v = torch.nn.functional.pad(v, (0, 1))
            e = torch.cat([e, e[:, -1:]], dim=1)
            sig = torch.nn.functional.pad(sig, (0, 1))
        (v, e, sig), (vS, eS, _sS) = _merge_round(v, e, sig)
        arrays.append((vS, eS))
    arrays.append((v, e))
    return arrays, total_bits


def contribs3(v: torch.Tensor, e: torch.Tensor):
    """Word contributions of <= 63-significant-bit slots ending at bit e:
    ([c0, c1, c2] int64 in [0, 2^32), we int64); c_j lands in word we - j.
    A merged value is never negative, so `>>` is the logical shift of
    flac_tpu's shift_right_logical."""
    we = (e - 1) >> 5
    r = e - (we << 5)                          # in [1, 32]
    c0 = ((v & _MASK32) << (32 - r)) & _MASK32
    v1 = v >> r
    return [c0, v1 & _MASK32, (v1 >> 32) & _MASK32], we


def merged_fill(arrays, maxwords: int) -> torch.Tensor:
    """The plain fill of merged slot arrays [(v, e), ...] (merged_slots'
    output) into words [B, maxwords] int32: each contribution goes in with
    one index_add_, those outside [0, maxwords) dropped."""
    B = arrays[0][0].shape[0]
    device = arrays[0][0].device
    dummy = B * maxwords
    rowbase = torch.arange(B, dtype=torch.int64, device=device)[:, None] * maxwords
    idx, src = [], []
    for v, e in arrays:
        if bool((v < 0).any()):
            raise AssertionError("a merged slot exceeds 63 significant bits")
        cs, we = contribs3(v, e)
        for j, c in enumerate(cs):
            w = we - j
            ok = (w >= 0) & (w < maxwords)
            idx.append(torch.where(ok, rowbase + w, dummy).flatten())
            src.append(c.flatten())
    words = torch.zeros(dummy + 1, dtype=torch.int64, device=device)
    words.index_add_(0, torch.cat(idx), torch.cat(src))
    return to_int32_bits(words[:dummy].reshape(B, maxwords))


def pack_fields_merged(values: torch.Tensor, nbits: torch.Tensor, maxwords: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain merged packer: the same (words [B, maxwords] int32,
    total_bits [B] int32) as pack_fields, by merged_slots + merged_fill."""
    arrays, total_bits = merged_slots(values, nbits)
    return merged_fill(arrays, maxwords), total_bits


def pack_fields_merged_kernel(values: torch.Tensor, nbits: torch.Tensor,
                              maxwords: int) -> tuple[torch.Tensor, torch.Tensor]:
    """pack_fields_merged done by the hand-written CUDA kernel
    (kernels.pack_words.pack_words_multi, fill-only, one launch with the
    prefix sum and the merge rounds inside) — the counterpart of flac_tpu's
    pack_fields_pallas_merged. CUDA tensors launch the kernel (a failure
    raises); CPU tensors take the plain version."""
    if values.device.type == "cpu":
        return pack_fields_merged(values, nbits, maxwords)
    return _pack_words.pack_words_multi(values.contiguous(), nbits.contiguous(),
                                        maxwords)


def stream_words_to_bytes(host_words: np.ndarray, total: int) -> np.ndarray:
    """Host-side serializer: big-endian word bytes, trimmed to `total`."""
    be = np.ascontiguousarray(host_words, dtype=np.uint32).astype(">u4")
    return np.frombuffer(be.tobytes(), np.uint8)[:int(total)]


# ---------------------------------------------------------------------------
# Dense stream compaction: the batch's frames back to back in one word
# stream on the device, so that only the compressed bytes come back to the
# host (flac_tpu's compact_stream_words; the CUDA kernel is
# csrc/compact_stream.cu).
# ---------------------------------------------------------------------------


def _byte_prefix_mask(v: torch.Tensor) -> torch.Tensor:
    """Mask of the first `v` (clamped to [0, 4]) big-endian bytes of a word."""
    partial = (_MASK32 << ((4 - torch.clamp(v, 1, 3)) * 8)) & _MASK32
    return torch.where(v >= 4, _MASK32, torch.where(v <= 0, 0, partial))


def compact_stream_words(words: torch.Tensor, total_bits: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch compaction, flac_tpu's formulation: byte starts from
    a cumsum, source bytes past each frame's tail masked, each frame's words
    funnel-shifted by its byte phase and written in frame order (flac_tpu's
    scan of dynamic_update_slices), the heads of frames that start mid-word
    added into the word before, the bytes past the stream's end zeroed.

    words [B, W] int32 (big-endian frame words), total_bits [B] int32 (each
    a multiple of 8). Returns (stream [B*W] int32 of uint32 bits, whose
    bytes 4k..4k+3 are word k's big-endian bytes, total int64 scalar, the
    stream's byte count)."""
    B, W = words.shape
    dev = words.device
    nbytes = (total_bits.to(torch.int64) + 7) // 8
    starts = torch.cumsum(nbytes, 0, dtype=torch.int64) - nbytes
    total = starts[-1] + nbytes[-1]
    Nw = B * W
    jj = torch.arange(W, dtype=torch.int64, device=dev)
    u = (words.to(torch.int64) & _MASK32) & _byte_prefix_mask(nbytes[:, None] - 4 * jj)
    # frame f's word j shifted so that output word (starts[f] + 3) >> 2 + j
    # holds frame bytes [(4 - p) + 4j, 8 - p + 4j) for phase p = starts[f] & 3
    p8 = ((starts & 3) * 8)[:, None]
    nxt = torch.cat([u[:, 1:], torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    sh = torch.where(p8 == 0, u, ((u << torch.clamp(32 - p8, max=31)) & _MASK32)
                     | (nxt >> p8))
    outpos = ((starts + 3) >> 2).tolist()
    buf = torch.zeros(Nw + W, dtype=torch.int64, device=dev)
    for f in range(B):  # in frame order; the start clamps as in a DUS
        pos = min(max(outpos[f], 0), Nw)
        buf[pos:pos + W] = sh[f]
    d0 = starts & 3
    head = torch.where(d0 > 0, u[:, 0] >> (8 * d0), 0)
    w0 = torch.clamp(starts >> 2, 0, Nw - 1)
    heads = torch.zeros(Nw, dtype=torch.int64, device=dev).index_add_(0, w0, head)
    out = buf[:Nw] | (heads & _MASK32)
    k = torch.arange(Nw, dtype=torch.int64, device=dev)
    out = out & _byte_prefix_mask(total - 4 * k)
    return to_int32_bits(out), total


def compact_stream_words_kernel(words: torch.Tensor, total_bits: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """compact_stream_words done by the hand-written CUDA kernel (one launch,
    one block a frame). CUDA tensors launch the kernel (a failure raises);
    CPU tensors take the plain version."""
    if words.device.type == "cpu":
        return compact_stream_words(words, total_bits)
    return _compact_stream.compact_stream(words, total_bits)


def big_endian_bytes(words: torch.Tensor) -> torch.Tensor:
    """The bytes of int32 words [..., n] (uint32 bits) in stream order, where
    they lie: uint8 [..., 4n]."""
    w = words.to(torch.int64) & _MASK32
    be = torch.stack([(w >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1)
    return be.to(torch.uint8).flatten(-2)


def compact_stream_bytes(words: torch.Tensor, total_bits: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """compact_stream_words_kernel, then the stream serialized to bytes where
    it lies: (stream [4*B*W] uint8, total int64 scalar). The encoder fetches
    words instead and serializes on the host."""
    out, total = compact_stream_words_kernel(words, total_bits)
    return big_endian_bytes(out), total


# ---------------------------------------------------------------------------
# Word-level CRC-16: reduce each 32-bit word mod G, carryless-multiply by a
# static per-position x^(32j+16) table, XOR-reduce, then multiply by
# x^(-8*pad) to cancel the zero padding. The packed words must hold ZEROS in
# the final 16-bit CRC slot; the CRC is inserted afterwards.
# ---------------------------------------------------------------------------

def _clmul_mod(a: int, b: int, poly: int, width: int) -> int:
    p = 0
    for i in range(width):
        if (b >> i) & 1:
            p ^= a << i
    g = (1 << width) | poly
    for bit in range(2 * width - 2, width - 1, -1):
        if (p >> bit) & 1:
            p ^= g << (bit - width)
    return p


@functools.lru_cache(maxsize=8)
def crc16_word_tables(maxwords: int) -> tuple[np.ndarray, np.ndarray]:
    """(tbl [maxwords] — x^(32*(maxwords-1-i)+16) mod G, the multiplier of
    word i in the zero-padded buffer; inv [4*maxwords+3] — x^(-8k) mod G,
    the pad fixup)."""
    poly, width = crc_mod.CRC16_POLY, 16
    xp = crc_mod.x_pow_mod_table(32 * maxwords + 17, poly, width)
    idx = 32 * (maxwords - 1 - np.arange(maxwords)) + 16
    tbl = xp[idx].astype(np.int32)
    # x^-1 mod G: x * u = G + 1 => u = (G+1)/x
    g_full = (1 << width) | poly
    u = (g_full ^ 1) >> 1
    u8 = u
    for _ in range(3):  # u^2, u^4, u^8
        u8 = _clmul_mod(u8, u8, poly, width)
    inv = np.zeros(4 * maxwords + 3, np.int32)
    cur = 1
    for k in range(len(inv)):
        inv[k] = cur
        cur = _clmul_mod(cur, u8, poly, width)
    return tbl, inv


def _reduce16(v: torch.Tensor, top: int) -> torch.Tensor:
    """v mod G for v < 2^(top+1)."""
    g16 = (1 << 16) | crc_mod.CRC16_POLY
    for bit in range(top, 15, -1):
        v = v ^ (((v >> bit) & 1) * (g16 << (bit - 16)))
    return v


def _clmul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = torch.zeros_like(a)
    for i in range(16):
        p = p ^ torch.where(((b >> i) & 1) == 1, a << i, 0)
    return p


def crc16_from_words(words: torch.Tensor, total_bits: torch.Tensor,
                     tbl: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """CRC-16 of each frame's bytes [0, nbytes-2) from its packed words
    (zeros in the final 16-bit slot). Returns [B] int32."""
    W = words.shape[1]
    r = _reduce16(words.to(torch.int64) & _MASK32, 31)  # word mod G: <= 16 bits
    acc = tree_reduce(_clmul16(r, tbl.to(torch.int64)[None, :]), torch.bitwise_xor)
    acc = _reduce16(acc, 30)
    # pad bytes after the CRC-16 message = buffer(4W) - nbytes + 2
    nbytes = torch.div(total_bits.to(torch.int32) + 7, 8, rounding_mode="floor")
    fix = inv.to(torch.int64)[(4 * W - nbytes + 2).long()]
    return _reduce16(_clmul16(acc, fix), 30).to(torch.int32)


def insert_crc16(words: torch.Tensor, total_bits: torch.Tensor,
                 crc: torch.Tensor) -> torch.Tensor:
    """OR each frame's CRC-16 into its (zero) last 16 bits; returns a new
    tensor."""
    B = words.shape[0]
    end = total_bits.to(torch.int32)
    we = ((end - 1) >> 5).long()
    rr = (end - (we.to(torch.int32) << 5)).to(torch.int64)  # in [8, 32]
    c = crc.to(torch.int64) & _MASK32
    wu = words.to(torch.int64) & _MASK32
    rows = torch.arange(B, device=words.device)
    wu[rows, we] += (c << (32 - rr)) & _MASK32
    # the CRC straddles two words when rr < 16
    wu[rows, torch.clamp(we - 1, min=0)] += torch.where(rr < 16, c >> rr, 0)
    return to_int32_bits(wu & _MASK32)


def pack_frames(values: torch.Tensor, nbits: torch.Tensor, maxwords: int,
                tbl: torch.Tensor, inv: torch.Tensor, merged: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain pack stage, flac_tpu's pack(): the word fill (pack_fields,
    or pack_fields_merged when `merged`), then crc16_from_words and
    insert_crc16. The fields must leave each frame's last 16 bits zero (the
    CRC-16 slot); tbl, inv = crc16_word_tables(maxwords). Returns (words
    [B, maxwords] int32, total_bits [B] int32)."""
    fill = pack_fields_merged if merged else pack_fields
    words, total_bits = fill(values, nbits, maxwords)
    crc = crc16_from_words(words, total_bits, tbl, inv)
    return insert_crc16(words, total_bits, crc), total_bits


def pack_frames_kernel(values: torch.Tensor, nbits: torch.Tensor, maxwords: int,
                       tbl: torch.Tensor, inv: torch.Tensor, merged: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """pack_frames as one launch of the hand-written CUDA kernel (banded, or
    the merged-slot fill when `merged`), with the prefix sum, the merge
    rounds and the CRC-16 inside. CUDA tensors launch the kernel (a failure
    raises); CPU tensors take the plain pack_frames."""
    if values.device.type == "cpu":
        return pack_frames(values, nbits, maxwords, tbl, inv, merged)
    launch = _pack_words.pack_words_multi if merged else _pack_words.pack_words
    return launch(values.contiguous(), nbits.contiguous(), maxwords, tbl, inv)
