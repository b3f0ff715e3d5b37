"""The output-driven decomposition of the CUDA compaction, held against
flac_tpu's `compact_stream_words` on the CPU.

`csrc/compact_stream.cu` gives each block chunks of 512 output words (128
threads, 4 words a thread; chunks b, b + grid, ... when the grid is capped
at what the card holds) and each thread the frame of its first word by a binary search over the byte starts that every block scans
into shared memory. Where all 16 bytes lie in that frame, each word is a
funnel shift of two of 5 source words at the frame's byte phase; otherwise
each word advances the frame, is a funnel shift of two of its frame's source
words, masked past the frame's tail, with the next frame's head ORed in
where it crosses into it; words from ceil(total / 4) on are zero. `_model` below is a plain numpy model of that index math, held against
flac_tpu's jitted compaction and the port's plain version on the edge cases
of the decomposition: frames of exactly 4 bytes at each phase, runs of
10-20-byte frames (many to a chunk), frames ending at each byte phase, a
frame of 4*W bytes, one frame, 512 silent frames of a level-5 encode
(several chunks a block on a capped grid), chunk boundaries inside a frame and on a frame boundary,
and garbage past every frame's tail. The kernel is held against the plain
version on the same cases on the card
(tests/test_torch_dense.py::test_cuda_compaction_kernel_matches_plain_on_card,
`-m cuda`, and chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flac_tpu.encode import packer as j_packer
from flac_tpu_torch.encode import frame_encoder as t_fe
from flac_tpu_torch.encode import packer as t_packer

THREADS, WARP = 128, 32      # csrc/compact_stream.cu's kThreads
CHUNK = THREADS * 4          # its kChunk: output words a block takes at a time
MASK = 0xFFFFFFFF


def _block_starts(total_bits: np.ndarray) -> np.ndarray:
    """A block's shared starts [B + 1]: each thread sums its run of `per`
    frames' bytes, an inclusive scan within each warp, the warp totals
    before it added; starts[B] is the total."""
    B = len(total_bits)
    nbytes = (total_bits.astype(np.int64) + 7) >> 3
    per = -(-B // THREADS)
    g0 = np.minimum(np.arange(THREADS) * per, B)
    g1 = np.minimum(g0 + per, B)
    csum = np.concatenate([[0], np.cumsum(nbytes)])
    local = csum[g1] - csum[g0]
    incl = np.cumsum(local.reshape(-1, WARP), axis=1)
    warp_sum = incl[:, -1]
    before = np.concatenate([[0], np.cumsum(warp_sum)[:-1]])
    run = (before[:, None] + incl - local.reshape(-1, WARP)).reshape(-1)
    starts = np.empty(B + 1, np.int64)
    for t in range(THREADS):  # each thread writes its run
        r = run[t]
        for g in range(g0[t], g1[t]):
            starts[g], r = r, r + nbytes[g]
    starts[B] = warp_sum.sum()
    return starts


def _frame_of(starts: np.ndarray, B: int, byte: np.ndarray) -> np.ndarray:
    """The binary search: the largest f in [0, B) with starts[f] <= byte."""
    lo, hi = np.zeros(len(byte), np.int64), np.full(len(byte), B - 1, np.int64)
    while np.any(lo < hi):
        mid = (lo + hi + 1) >> 1
        take = starts[mid] <= byte
        lo, hi = np.where((lo < hi) & take, mid, lo), np.where((lo < hi) & ~take, mid - 1, hi)
    return lo


def _funnel(lo: np.ndarray, hi: np.ndarray, q: np.ndarray) -> np.ndarray:
    """__funnelshift_l(lo, hi, 8q): the high word of (hi:lo) << 8q."""
    pair = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((pair << (8 * q).astype(np.uint64)) >> np.uint64(32)).astype(np.int64) & MASK


def _model(words: np.ndarray, total_bits: np.ndarray, grid: int | None = None
           ) -> tuple[np.ndarray, int]:
    """The kernel's output on `grid` blocks (default one a chunk), computed
    as its blocks and threads compute it: (stream [B*W] uint32, total).
    Asserts that every word is written once."""
    B, W = words.shape
    src = words.view(np.uint32).astype(np.int64).reshape(-1)
    nw = B * W
    nchunks = -(-nw // CHUNK)
    grid = min(grid or nchunks, nchunks)
    starts = _block_starts(total_bits)  # every block scans the same starts
    total = int(starts[B])
    nv = (total + 3) >> 2
    # block b takes chunks b, b + grid, ...; thread t words 4t..4t+3 of each
    k0 = np.concatenate([(c * CHUNK + 4 * np.arange(THREADS))
                         for b in range(grid) for c in range(b, nchunks, grid)])
    k0 = k0[k0 < nw]
    out = np.zeros(nw, np.int64)
    written = np.zeros(nw, np.int64)
    live = k0[k0 < nv]
    b0 = 4 * live
    f = _frame_of(starts, B, b0)
    start, end = starts[f], starts[f + 1]
    fast = b0 + 16 <= end
    # all 16 bytes inside frame f: source words j .. j + 4, a funnel shift each
    fk, ff, o, nb = live[fast], f[fast], (b0 - start)[fast], (end - start)[fast]
    j, q = o >> 2, o & 3
    s = [src[ff * W + j + i] for i in range(4)]
    has4 = (q > 0) & (4 * (j + 4) < nb)
    s.append(np.where(has4, src[np.where(has4, ff * W + j + 4, 0)], 0))
    for i in range(4):
        out[fk + i] = _funnel(s[i + 1], s[i], q)
    # crossing_words: word i of each other group, f advancing, loads predicated
    ck, f = live[~fast], f[~fast]
    for i in range(4):
        k = ck + i
        byte = 4 * k
        ok = byte < total
        while True:
            step = ok & (starts[np.minimum(f + 1, B)] <= byte)
            if not step.any():
                break
            f = f + step
        s, e = starts[f], starts[np.minimum(f + 1, B)]
        nb, o = e - s, byte - s
        j = o >> 2
        assert np.all(~ok | ((o >= 0) & (o < nb) & (nb <= 4 * W)))
        row = f * W
        a = np.where(ok, src[np.where(ok, row + j, 0)], 0)
        has_b = ok & ((o & 3) > 0) & (4 * (j + 1) < nb)
        b = np.where(has_b, src[np.where(has_b, row + j + 1, 0)], 0)
        has_h = ok & (nb - o < 4) & (f + 1 < B)
        h = np.where(has_h, src[np.where(has_h, row + W, 0)], 0)
        shift = np.where(ok, 8 * (o & 3), 0)
        keep = np.where(ok, np.minimum(nb - o, 4), 4)
        w = _funnel(b, a, shift // 8)
        cut = keep < 4
        kc = np.clip(keep, 1, 3)
        w = np.where(cut, (w & ((MASK << (32 - 8 * kc)) & MASK)) | (h >> (8 * kc)), w)
        out[k[k < nw]] = w[k < nw]
    for i in range(4):  # every word of every group is stored, zeros included
        k = k0 + i
        np.add.at(written, k[k < nw], 1)
    assert np.all(written == 1)
    return out.astype(np.uint32), total


@functools.lru_cache(maxsize=1)
def _silent_batch(B: int = 512, T: int = 4096):
    """B silent stereo 16-bit frames of a level-5 encode (14-15 bytes each),
    the port's frame encoder on the CPU."""
    cfg = t_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    words, total_bits, _ = t_fe.build_frame_encoder(cfg, device="cpu")(
        np.zeros((B, T, 2), np.int32), np.arange(B))
    return words.numpy(), total_bits.numpy()


@functools.lru_cache(maxsize=1)
def edge_cases() -> dict:
    """name -> (words [B, W] int32, total_bits [B] int32): chip_smoke.py's
    compaction_edge_cases, which phase 12 holds the kernel to on the card."""
    return {name: (w, tb) for name, w, tb in chip_smoke.compaction_edge_cases(*_silent_batch())}


# the cases are built when a test first needs them, not at import
CASE_NAMES = [*(f"four_byte_frames_phase{p}" for p in range(4)), "tiny_frames_many_to_a_chunk",
              "ends_at_each_phase", "frames_of_4W_bytes", "one_frame", "chunk_boundaries",
              "garbage_past_tails", "silence_512", "frames_8192"]


def test_edge_cases_are_what_they_say():
    cases = edge_cases()
    assert sorted(cases) == sorted(CASE_NAMES)
    for p in range(4):
        assert _block_starts(cases[f"four_byte_frames_phase{p}"][1])[1] % 4 == p
    assert set(_block_starts(cases["ends_at_each_phase"][1])[1:] % 4) == {0, 1, 2, 3}
    words, total_bits = cases["frames_of_4W_bytes"]
    assert _block_starts(total_bits)[5] % 4 == 1 and total_bits[5] == 32 * words.shape[1]
    words, total_bits = cases["chunk_boundaries"]
    starts = _block_starts(total_bits)
    assert starts[2] < 4 * CHUNK < starts[3] and starts[8] == 16 * CHUNK
    words, total_bits = cases["silence_512"]
    assert words.shape[0] == 512 and words.size > 132 * 16 * CHUNK
    assert set(total_bits // 8) <= set(range(10, 21))
    assert 8 * (len(cases["frames_8192"][1]) + 1) > 48 * 1024


@pytest.mark.parametrize("name", CASE_NAMES)
def test_model_matches_flac_tpu(name):
    words, total_bits = edge_cases()[name]
    ref_w, ref_total = j_packer.compact_stream_words(jnp.asarray(words),
                                                     jnp.asarray(total_bits))
    ref_w = np.asarray(ref_w).view(np.uint32)
    plain_w, plain_total = t_packer.compact_stream_words(torch.as_tensor(words),
                                                         torch.as_tensor(total_bits))
    assert int(plain_total) == int(ref_total)
    np.testing.assert_array_equal(plain_w.numpy().view(np.uint32), ref_w)
    for grid in (None, 1584, 7):  # one block a chunk; capped (132 SMs x 12); 7
        got_w, got_total = _model(words, total_bits, grid)
        assert got_total == int(ref_total)
        np.testing.assert_array_equal(got_w, ref_w)
