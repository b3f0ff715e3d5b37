#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. env            — requires CUDA; prints the card's name and power limit as
                    nvidia-smi gives them, and builds every CUDA kernel from
                    csrc/ (one nvcc per source, all started together).
2. kernels        — holds the pack kernel's banded instantiation
                    (pack_words: prefix sum, word fill and CRC-16 in one
                    launch) against its plain PyTorch composition on the
                    card, bit for bit, in both modes: fill-only against
                    pack_fields on the cases of tests/test_packer_pallas.py
                    (regenerated from their seeds), fused against
                    pack_fields -> crc16_from_words -> insert_crc16 on the
                    same cases with a byte-align pad and a zero CRC-16 slot
                    appended, both again with frames split into 32-word tiles
                    (the tiled path); both modes on the real fields of
                    level-5 batches (B=64, the stream's final partial block,
                    B=512, T=4096, stereo) and fused on the B=64 batch in
                    1,024-word tiles; fused on two synthetic frames of more
                    than 3 full shared tiles, which must take the tiled path
                    and its CRC kernel. Then times the kernel (fused and
                    fill-only, replays of a CUDA graph of 20 launches, so the
                    launcher's host work is left out; and back to back from
                    Python), the plain composition and one index_add_ of the
                    fill's contributions (the library yardstick, which the
                    port never calls) at B=512 and B=64, with the bound.
3. kernels_merged — the same for the merged-slot instantiation
                    (pack_words_multi, the merge rounds inside), against
                    pack_fields_merged and its composition; the all-spill
                    case is among the packer cases.
4. encode         — the main path: encode_file(level=5) of 60 s of 44.1 kHz
                    stereo 16-bit PCM made from a seed, on the card, through
                    the dense route (each batch of full frames compacted on
                    the card, its valid words copied back and written in one
                    piece); the pack kernel's launch count must equal the
                    number of frame batches (the final partial block
                    included), the compaction kernel's the number of
                    batches of full frames (the partial frame takes the
                    padded route), and the stream's SHA-256 the padded route's. The
                    file is
                    decoded by the port's host decoder (CRC-8, CRC-16 and MD5
                    checked) and must give the PCM back. The first batch is
                    also encoded on the CPU, and must give the same bytes
                    frame for frame. One 64-frame batch
                    is timed by stage on the host clock (the two device
                    stages; the host's MD5, and the copy back and emit of
                    the dense route and of the padded one, the CPU's, at the
                    same point) and once under
                    torch.profiler (device busy time, device events); the idle
                    share divides the busy time by the unprofiled wall; 3
                    pack() calls under the profiler (after a warm-up step)
                    must be 3 pack kernels and no other device event. The whole encode runs once more under
                    torch.profiler (device only); its busy time over the first
                    run's wall gives the run's idle share. The stream's SHA-256
                    is printed, to compare streams across versions.
5. encode_merged  — encode_file(level=5, verify=True) of the same 60 s under
                    FLAC_TPU_PACKER=merged: its bytes must equal phase 4's,
                    pack_words_multi must launch once a batch, the
                    compaction once a batch of full frames, and the
                    verifier must decode every batch of full frames through
                    the decode kernels (the subframe scan once a channel, the
                    restore once) without a VerifyError; the dense verify
                    decodes flac_tpu's byte rows (each frame in a row of the
                    batch's largest frame length). The merged encode
                    runs once more without verify, for the fill's own cost,
                    then the banded encode once more, and one 64-frame batch
                    is timed by stage as in phase 4 with each fill, so that
                    the two fills are compared at one point of the run.
6. kernels_decode — holds the subframe-scan kernel (the subframe-header parse
                    and the residual scan in one) against its plain version,
                    read_subframe_header then narrow_residual_scan, bit for
                    bit on every output (every parse field, res, end
                    positions, overflow flags): on both channels of the first
                    512 frames of phase 4's stream; on three bit strings at
                    the scan's guards (a Rice fold that trips, one that
                    decodes exactly, a unary run of 60 zeros), each behind a
                    FIXED order-0, RICE2 subframe header; and on 512 random
                    starts in random words with zero runs (every header
                    branch: corrupt types, long wasted runs, negative sample
                    widths and positions). Holds the restore kernel against
                    restore_scan on the two channels' rows stacked and on the
                    random rows. Then times kernels and plain versions at
                    B=512, T=4096.
7. decode         — decode_bytes_device of phase 4's stream on the card: the
                    exact input, MD5 checked, on path "device", with only the
                    final partial frame on the host, the subframe scan
                    launched batches x channels times and the restore once a
                    batch; iter_blocks gives the same PCM. The decode runs 5
                    more times for the spread of its wall. One 512-frame batch
                    is timed by stage and once under torch.profiler, and the
                    whole decode runs again under torch.profiler for its
                    device idle share.
8. encode_hires    — the slice's main path: encode_file(level=8, verify=True)
                    of 30 s of 96 kHz stereo 24-bit PCM made from a seed
                    (a sine mix plus noise at 24-bit scale), blocksize 4096,
                    batches of 64: one pack launch a batch, one compaction
                    a batch of full frames, the verifier's
                    narrow scan once a channel and the restore once a batch
                    of full frames, no VerifyError; the same bytes again
                    without verify; a lossless decode by the port's host
                    decoder; the first 16 frames encoded on the CPU give the
                    same bytes. One 64-frame batch is timed by stage and its
                    device idle share taken as in phase 4; the SHA-256 must
                    be the padded route's. Then 10 s of the same format with -p and escape
                    coding on tests/test_escape.py's burst signal: escaped
                    partitions, lossless, the first 8 frames CPU-identical.
9. decode_hires    — decode_bytes_device of the 24-bit stream: the exact input,
                    MD5 checked, on path "device" (the partial frame and any
                    frame the scan flags on the host, counted), the narrow
                    scan launched batches x channels times; its wall, then
                    the median of 5 more. Holds the narrow scan and the
                    restore (W = 16 taps, order 12) against their plain
                    versions on the stream's first 512 frames, and the pack
                    kernel on one level-8 24-bit batch.
10. wide           — encode_file(level=5, verify=True) of 5 s of 44.1 kHz
                    stereo at 28 bits (mid-side on: a 29-bit side channel,
                    the int64 LPC path) and at 32 bits (mid-side off): the
                    verifier through the wide scan kernel, the compaction
                    once a batch of full frames; lossless on the
                    host decoder; then decode_bytes_device of each gives the
                    exact input through the wide scan kernel, launches
                    counted.
11. kernels_wide   — holds the wide scan kernel against wide_residual_scan's
                    composition bit for bit on every output (every parse
                    field, int64 res, end positions, overflow flags): the
                    first 512 frames of phase 4's stream read wide, every
                    frame of phase 10's 32-bit stream, the guard strings
                    (the fold strings, which the wide scan has no guard for;
                    a unary run of 60 zeros; VERBATIM 32-bit samples that
                    outrun the refill) and phase 6's 512 random starts; the
                    restore's int64-res instantiation on the same rows. Times
                    the kernel and the plain version at B=512, T=4096, with
                    the bound.
12. kernels_compact — holds the compaction kernel against compact_stream_words,
                    bit for bit on every word and the total, on the four
                    cases of tests/test_dense_path.py::TestCompaction
                    (regenerated from seed 123) and the packed words of a
                    level-5 B=64 batch, a 24-bit -8 B=64 batch and a level-5
                    B=512 batch; times the kernel (CUDA-graph replay), the
                    plain version and one torch.masked_select of the byte
                    rows (the library yardstick, which the port never calls;
                    CUDA events, since it synchronises) on the three real
                    batches, with the bytes bound.
13. decode_variable — a variable-blocksize stream made from the 60 s PCM
                    (segments encoded at 4096, 2304 and 1152 by encode_file,
                    plus three frames of 1000, each frame re-headered as
                    blocking strategy 1): decode_bytes_device gives the
                    exact input on path "device-variable", MD5 checked, the
                    scan launched channels x group batches and the restore
                    once a group batch, the 1000-sample frames on the host;
                    iter_blocks gives the same PCM; the wall, then the
                    median of 5 more.
14. seek_stream    — SeekableDecoder.decode_range on phase 4's stream at 4
                    positions (from 0, from mid-frame, across a 64-frame
                    batch of the device read, the final partial frame), each
                    equal to the input slice, decode launches counted;
                    ChunkedStreamDecoder over an io.BytesIO in 1 MiB windows
                    gives the input back (MD5 checked); lpc_restore on the
                    card (one restore launch) against its plain version on
                    the LPC subframes of the stream's first 512 frames, and
                    both timed beside the restore's bound for those rows.
15. replaygain     — the equal-loudness kernel (csrc/iir_scan.cu, both IIR
                    stages, one block a channel, many titles a launch)
                    against its plain version on the card, on 0.25 s
                    excerpts at 44.1 kHz (loud, and near silent), 96 kHz
                    24-bit and 8 kHz near silent: within 1e-9 of the
                    output's peak, bit for bit equal to
                    replaygain.fma_reference (flac_tpu's order of
                    operations) on the first 300 samples, equal title gains
                    from both routes. One ragged launch over stereo titles
                    of 1, 255, 257 and 4097 samples and the 96 kHz excerpt:
                    each bit-equal to fma_reference on its first samples and
                    to its own one-title launch. One launch over 150 stereo
                    titles of 1 to 20,000 samples (300 blocks, more than
                    the 132 SMs): each bit-equal to its own launch and to
                    fma_reference on its first samples. The float64 FMA and add
                    latencies by a one-thread probe. Then an album of four
                    44.1 kHz titles (3, 3.5, 4 and 4.5 min, each at its own
                    loudness) encoded at level 5 with a PADDING block and
                    tagged by add_replay_gain_tags: one kernel launch for
                    the album, the five tags in flac_tpu's formats, the
                    title gains rising as the loudness falls, the audio
                    bytes untouched, each file decoding on the card to its
                    input (MD5 checked); the album again by stage (decode
                    and upload a title, equal_loudness_album's one launch
                    by CUDA events, copy back and host statistics a title),
                    every title of that launch within 1e-9 of its peak
                    against the plain version; the first title alone, timed
                    and bit-equal to its segment of the album's launch;
                    compute_replay_gain in three launches under a lowered
                    LAUNCH_BYTES, with the one launch's gains and peaks;
                    and `metaflac --add-replay-gain` on
                    phase 8's 24-bit/96 kHz stream, on the card by the
                    device rule.
16. the `kernels` line, one entry per ported kernel, with its launches on its
   path, error against the plain version, and times.

The last line is the device line {"ok": true, "device": {...}}.
`same_card.py` compares two versions of the port on one card.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SAMPLE_RATE = 44100
SECONDS = 60
BLOCKSIZE = 4096
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
# int32 multiply-adds a second on an H100 SXM: 64 int32 lanes per SM, half
# the float32 lanes behind the data sheet's 67 TFLOP/s, where an FMA counts
# as two flops. An int64 multiply-add is counted as one of them (a floor).
INT32_MACS_PER_S = 67e12 / 4
MASK32 = 0xFFFFFFFF
SMALL_TILE = 32             # words: a tile that splits the packer cases' frames
DECODE_B = 512              # the stream decoder's batch for long streams
DECODE_MAXORD = 32          # the stream decoder's default max_lpc_order
HIRES_RATE = 96000          # the hi-res archival format: 24-bit/96 kHz stereo at -8
HIRES_SECONDS = 30
PE_SECONDS = 10             # the -p and escape-coding encode of that format
WIDE_SECONDS = 5            # the 28- and 32-bit streams (44.1 kHz stereo, -5)
# ReplayGain's album: four 44.1 kHz stereo 16-bit titles at level 5 (15 min
# in all), each at its own loudness (a share of make_pcm's level)
ALBUM_MINUTES = (3.0, 3.5, 4.0, 4.5)
ALBUM_LOUDNESS = (1.0, 0.5, 0.2, 0.05)
RG_EXCERPT_S = 0.25         # the kernel-against-plain excerpts
RG_EXACT = 300              # samples a channel held against fma_reference
# the ragged launch's titles beside a 96 kHz excerpt, samples a channel:
# one sample, a tile less one, a tile plus one, 16 tiles plus one
RG_RAGGED = (1, 255, 257, 4097)
# a launch of more blocks than the H100's 132 SMs: stereo titles of 1 to
# RG_MANY_MAX samples, each held against its own launch and against
# fma_reference on its first RG_MANY_EXACT samples
RG_MANY_TITLES = 150
RG_MANY_MAX = 20000
RG_MANY_EXACT = 32
RG_REL_TOL = 1e-9           # kernel against plain, of the output's peak
# float64 operations a second on an H100 SXM outside the tensor cores
# (NVIDIA data sheet: 34 TFLOP/s, an FMA counted as two)
FP64_FLOPS_PER_S = 34e12
# float64 operations the filter does a sample and channel: 26 FMAs (two
# flops each) and 6 additions or subtractions (csrc/iir_scan.cu)
RG_FLOPS_PER_SAMPLE = 26 * 2 + 6
# the SHA-256 of the streams of phases 4 and 8 as the padded route writes
# them: the dense route must give the same bytes
SHA256_60S_16BIT_L5 = "42e870d8dfd0eacf428343ecfac8905ae86f67c8a6dd5b6d83470af0fee9847d"
SHA256_30S_24BIT_L8 = "9b9dcefa258eb4f3ea934f8b4a9fdc564db3424c761417c592b662193cad3626"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def make_pcm(n: int, seed: int = 0, rate: int = SAMPLE_RATE, bits: int = 16,
             sigma: float | None = None) -> np.ndarray:
    """Stereo test music: a sine mix per channel plus Gaussian noise (in the
    style of tests/conftest.make_signal), at `bits` bits; the noise's sigma
    scales with the sample width (64 at 16 bits) unless given."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = (1 << (bits - 1)) - 1
    if sigma is None:
        sigma = 64.0 * 2.0 ** (bits - 16)
    out = np.zeros((n, 2), np.int32)
    for c in range(2):
        f1, f2 = 441.0 * (c + 1), 1234.5 + 100 * c
        x = (0.6 * np.sin(2 * np.pi * f1 * t / rate)
             + 0.3 * np.sin(2 * np.pi * f2 * t / rate))
        noisy = np.round(x * amp * 0.8 + rng.normal(0, sigma, n))
        out[:, c] = np.clip(noisy, -amp - 1, amp).astype(np.int64).astype(np.int32)
    return out


def burst_pcm(n: int, bits: int, seed: int = 1, every: int = 1 << 17,
              length: int = 512) -> np.ndarray:
    """tests/test_escape.py::_burst_signal at length n: a quiet tone (5% of
    full scale) with a full-scale noise burst of `length` samples every
    `every` samples, each confined to a few Rice partitions, where an
    escaped (raw) partition beats Rice; the right channel is 0.9 x the
    left."""
    rng = np.random.default_rng(seed)
    full = (1 << (bits - 1)) - 1
    t = np.arange(n)
    sig = np.round(0.05 * full * np.sin(2 * np.pi * t / 97.0)).astype(np.int64)
    for s in range(every // 2, n - length, every):
        sig[s:s + length] = rng.integers(-full - 1, full, length)
    return np.stack([sig, np.round(0.9 * sig).astype(np.int64)], axis=-1).astype(np.int32)


def frames_differing(cfg, frames: np.ndarray, dev) -> tuple[int, int]:
    """(frames, bytes) that differ between the frame encoder on the CPU and
    on the card, for one batch of frames numbered from 0."""
    from flac_tpu_torch.encode.frame_encoder import build_frame_encoder
    fnos = np.arange(len(frames))
    wc, tc, _ = build_frame_encoder(cfg, device="cpu")(frames, fnos)
    wg, tg, _ = build_frame_encoder(cfg, device=dev)(frames, fnos)
    wg, tg = wg.cpu(), tg.cpu()
    n_frames = n_bytes = 0
    for i in range(len(frames)):
        a = wc[i].numpy().astype(">u4").tobytes()[: int(tc[i]) // 8]
        b = wg[i].numpy().astype(">u4").tobytes()[: int(tg[i]) // 8]
        if a != b:
            n_frames += 1
            m = min(len(a), len(b))
            n_bytes += int((np.frombuffer(a[:m], np.uint8)
                            != np.frombuffer(b[:m], np.uint8)).sum()) + abs(len(a) - len(b))
    return n_frames, n_bytes


def random_fields(rng, B, F, maxwords, long_frac=0.05):
    """tests/test_packer_pallas.py::_random_fields, in numpy."""
    nbits = rng.integers(0, 34, size=(B, F)).astype(np.int32)
    longm = rng.random((B, F)) < long_frac
    nbits = np.where(longm, rng.integers(34, 90, size=(B, F)), nbits)
    tot = nbits.sum(1)
    while (tot > maxwords * 32 - 32).any():
        nbits = np.where((tot > maxwords * 32 - 32)[:, None], nbits // 2, nbits)
        tot = nbits.sum(1)
    sig = np.minimum(nbits, 33).astype(np.int64)
    values = rng.integers(0, 1 << 62, size=(B, F)) & ((1 << sig) - 1)
    return values, nbits.astype(np.int32)


def packer_cases():
    """(name, values, nbits, maxwords) of tests/test_packer_pallas.py."""
    for case, (B, F, maxwords) in enumerate([(8, 300, 96), (8, 130, 6),
                                             (9, 257, 520)]):
        rng = np.random.default_rng(7 * case + 1)
        yield (f"random_{B}x{F}_w{maxwords}", *random_fields(rng, B, F, maxwords),
               maxwords)
    rng = np.random.default_rng(42)
    nbits = np.zeros((8, 1400), np.int32)
    nbits[:, 0], nbits[:, 700], nbits[:, -1] = 20, 33, 33
    sig = np.minimum(nbits, 33).astype(np.int64)
    yield ("zero_runs_8x1400_w40",
           rng.integers(0, 1 << 62, size=(8, 1400)) & ((1 << sig) - 1), nbits, 40)
    rng = np.random.default_rng(5)
    yield ("all_33bit_8x64_w70", rng.integers(0, 1 << 33, size=(8, 64)),
           np.full((8, 64), 33, np.int32), 70)


def with_crc_slot(values, nbits, maxwords):
    """A frame as the frame assembler leaves it: a byte-align pad and a zero
    16-bit CRC-16 slot appended, two more words of room."""
    B = len(values)
    pad = (-(nbits.sum(1) + 16)) % 8
    nbits = np.concatenate([nbits, pad[:, None], np.full((B, 1), 16)], 1).astype(np.int32)
    return np.concatenate([values, np.zeros((B, 2), np.int64)], 1), nbits, maxwords + 2


def crc_slot_cases():
    """packer_cases with the CRC slot appended, as tests/test_torch_packer.py
    builds its CRC-16 cases."""
    for name, values, nbits, maxwords in packer_cases():
        yield (f"{name}_crc_slot", *with_crc_slot(values, nbits, maxwords))


def tiled_case(tile_words: int, seed: int = 13):
    """Two frames of random fields whose words fill more than 3 shared tiles
    of the pack kernel (an 8-channel 8-bit frame of 65,535 samples needs
    about 180 K words), with the CRC slot appended."""
    maxwords = 3 * tile_words + 4097
    nfields = maxwords * 32 * 4 // (5 * 19)  # ~19 bits a field fill 4/5
    values, nbits = random_fields(np.random.default_rng(seed), 2, nfields, maxwords)
    values, nbits, maxwords = with_crc_slot(values, nbits, maxwords)
    return f"tiled_2x{nbits.shape[1]}_w{maxwords}", values, nbits, maxwords


def fill_contributions(values, nbits, maxwords, merged):
    """(idx, src) int64: every word contribution of the fill, banded (c0, c1
    of each field) or merged (c0-c2 of each merged and spill slot), at its
    flat word index, those outside [0, maxwords) sent to index B * maxwords:
    one index_add_ of them is the fill's library yardstick."""
    from flac_tpu_torch.encode import packer
    B = values.shape[0]
    rowbase = torch.arange(B, device=values.device, dtype=torch.int64)[:, None] * maxwords
    dummy = B * maxwords
    idx, src = [], []

    def add(w, c):
        idx.append(torch.where((w >= 0) & (w < maxwords), rowbase + w, dummy).flatten())
        src.append(c.flatten())

    if merged:
        arrays, _ = packer.merged_slots(values, nbits)
        for v, e in arrays:
            cs, we = packer.contribs3(v, e)
            for j, c in enumerate(cs):
                add(we - j, c)
    else:
        ends = torch.cumsum(nbits, dim=1, dtype=torch.int32)
        we = ((ends - 1) >> 5).to(torch.int64)
        r = ends.to(torch.int64) - (we << 5)
        has = nbits > 0
        vv = torch.where(has, values, 0)
        add(torch.where(has, we, -1), torch.where(has, (vv << (32 - r)) & MASK32, 0))
        add(torch.where(has, we - 1, -1), (vv >> r) & MASK32)
    return torch.cat(idx), torch.cat(src)


# a FIXED order-0 subframe header, then RICE2 with partition order 0
GUARD_SUBFRAME_HEADER = "00010000" + "01" + "0000"


def fold_guard_words(n: int = 8) -> dict:
    """RICE2 partitions of n samples with k=26, behind GUARD_SUBFRAME_HEADER:
    the two bit strings of tests/test_device_decoder.py::TestNarrowScan.
    test_fold_guard (q=47 trips the fold guard; q=15 decodes exactly) and a
    unary run of 60 zeros. name -> words (int32, zero-padded)."""
    k26 = GUARD_SUBFRAME_HEADER + format(26, "05b")
    tail = ("1" + "0" * 26) * (n - 1)
    lsb = format(0x155AA55 & ((1 << 26) - 1), "026b")
    out = {}
    for name, bits in (("fold_trips", k26 + "0" * 47 + "1" + lsb + tail),
                       ("fold_exact", k26 + "0" * 15 + "1" + format(123, "026b") + tail),
                       ("unary_60", k26 + "0" * 60 + "1" + tail)):
        bits += "0" * ((-len(bits)) % 32)
        w = np.array([int(bits[i:i + 32], 2) for i in range(0, len(bits), 32)],
                     dtype=np.uint64).astype(np.uint32).view(np.int32)
        out[name] = np.concatenate([w, np.zeros(16, np.int32)])
    return out


def verbatim_words(bits: int, n: int, seed: int = 9) -> np.ndarray:
    """A VERBATIM subframe header and n random samples of `bits` bits (as
    words, zero-padded): at 32 bits a step of 4 samples spends 128 bits,
    more than the wide scan's 96-bit refill brings, so its window runs dry
    and the scan must flag the frame."""
    rng = np.random.default_rng(seed)
    bits_s = "00000010" + "".join(format(int(v), f"0{bits}b")
                                  for v in rng.integers(0, 1 << bits, n, dtype=np.uint64))
    bits_s += "0" * ((-len(bits_s)) % 32)
    w = np.array([int(bits_s[i:i + 32], 2) for i in range(0, len(bits_s), 32)],
                 dtype=np.uint64).astype(np.uint32).view(np.int32)
    return np.concatenate([w, np.zeros(16, np.int32)])


def random_subframes(n: int = 512, nwords: int = 1 << 14, seed: int = 3):
    """Random words with zero runs, and n random subframe starts with their
    sample widths (16 or 17). A quarter of the starts get a header byte with
    the wasted-bits flag set (a third of them VERBATIM, the rest of a random
    type), then a zero run of up to 600 bits: long wasted runs, negative
    sample widths, and positions that go below 0 (VERBATIM samples of a
    negative width move back). Returns (words int32 [nwords], starts int64
    [n], cbps [n])."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 1 << 32, nwords, dtype=np.uint64).astype(np.uint32)
    for s in rng.integers(0, nwords - 40, nwords // 200):
        u[s:s + rng.integers(1, 41)] = 0
    starts = rng.integers(0, (nwords - 64) * 32, n)
    bits = np.unpackbits(u.astype(">u4").view(np.uint8))
    for i, s in enumerate(starts[: n // 4]):
        run = int(rng.integers(0, 601))
        hdr = ((1 if i % 3 == 0 else int(rng.integers(0, 64))) << 1) | 1
        bits[s:s + 8] = np.unpackbits(np.array([hdr], np.uint8))
        bits[s + 8:s + 8 + run] = 0
        bits[s + 8 + run] = 1
    words = np.packbits(bits).view(">u4").astype(np.uint32).view(np.int32)
    return words, starts.astype(np.int64), rng.integers(16, 18, n).astype(np.int64)


def compaction_cases():
    """tests/test_dense_path.py::TestCompaction's four cases, regenerated
    from seed 123: (name, words [B, W] int32, total_bits [B] int32) of 37
    frames of 11 to 96 random bytes (every byte phase), many of 11 bytes,
    all of 96."""
    rng = np.random.default_rng(123)
    B, W = 37, 24
    cases = []
    for trial in range(4):
        nbytes = rng.integers(11, 4 * W + 1, B)
        if trial == 2:
            nbytes[::5] = 11
        if trial == 3:
            nbytes[:] = 4 * W
        words = np.zeros((B, W), np.uint32)
        for i, nb in enumerate(nbytes):
            padded = np.zeros(4 * W, np.uint8)
            padded[:nb] = rng.integers(0, 256, nb, dtype=np.uint8)
            words[i] = padded.view(">u4").astype(np.uint32)
        cases.append((f"test_dense_path_{trial}", words.view(np.int32),
                      (nbytes * 8).astype(np.int32)))
    return cases


def utf8_number(n: int) -> bytes:
    """FLAC's UTF-8 coding of a frame or sample number (up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    for nb in range(2, 8):
        if n < 1 << (5 * nb + 1):
            tail = [0x80 | ((n >> (6 * i)) & 0x3F) for i in range(nb - 2, -1, -1)]
            return bytes([((0xFF00 >> nb) & 0xFF) | (n >> (6 * (nb - 1)))] + tail)
    raise ValueError(f"{n} does not fit FLAC's UTF-8 coding")


def variable_blocksize_stream(pcm, segments, sample_rate, bps, encode):
    """A variable-blocksize FLAC stream of pcm[:sum(bs * n)]: each segment
    (blocksize, nframes) is encoded by `encode(pcm_segment, blocksize)` as a
    fixed-blocksize stream, and each of its frames re-headered as blocking
    strategy 1, with its first sample's number in UTF-8 and the CRC-8 and
    CRC-16 recomputed; the subframe bytes are unchanged. One STREAMINFO with
    the min/max blocksize and the input's MD5 goes in front. (A copy lives
    in tests/test_torch_variable.py.)"""
    from flac_tpu_torch import crc
    from flac_tpu_torch.decode.host_decoder import HostDecoder
    from flac_tpu_torch.md5 import MD5Context
    from flac_tpu_torch.metadata import StreamInfo, serialize_block

    frames, sizes, sample = [], [], 0
    for bs, nframes in segments:
        data = encode(pcm[sample:sample + bs * nframes], bs)
        _pcm, infos = HostDecoder(data).decode_all()
        assert len(infos) == nframes and all(fi.blocksize == bs for fi in infos)
        for fi in infos:
            raw = data[fi.offset:fi.offset + fi.size]
            lead = raw[4]
            ulen = 1 + sum(lead >= b for b in (0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE))
            bs_code, sr_code = raw[2] >> 4, raw[2] & 15
            ext = ({6: 1, 7: 2}.get(bs_code, 0)
                   + {12: 1, 13: 2, 14: 2}.get(sr_code, 0))
            hdr = bytes([raw[0], raw[1] | 1, raw[2], raw[3]]) + utf8_number(sample) \
                + raw[4 + ulen:4 + ulen + ext]
            frame = hdr + bytes([crc.crc8(hdr)]) + raw[4 + ulen + ext + 1:-2]
            frame += crc.crc16(frame).to_bytes(2, "big")
            frames.append(frame)
            sizes.append(len(frame))
            sample += bs
    md5 = MD5Context()
    md5.accumulate(pcm[:sample], bps)
    si = StreamInfo(min_blocksize=min(bs for bs, _ in segments),
                    max_blocksize=max(bs for bs, _ in segments),
                    min_framesize=min(sizes), max_framesize=max(sizes),
                    sample_rate=sample_rate, channels=pcm.shape[1],
                    bits_per_sample=bps, total_samples=sample, md5sum=md5.digest())
    return b"fLaC" + serialize_block(si, is_last=True) + b"".join(frames)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one call, from CUDA events around replays of a
    CUDA graph of `iters` calls: the launches follow one another on the
    device without the host's per-call Python and launch overhead, which
    time_ms measures too when a kernel is shorter than it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * iters)
    del graph
    return ms


def busy_ms(spans) -> float:
    """Length of the union of (start, end) spans given in microseconds, in ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from flac_tpu_torch import _native
    from flac_tpu_torch.decode import frame_decoder as fd
    from flac_tpu_torch.decode import seek as sk
    from flac_tpu_torch.decode import stream as st
    from flac_tpu_torch.decode import streaming as sm
    from flac_tpu_torch.dsp import lpc
    from flac_tpu_torch.decode.host_decoder import HostDecoder, decode_bytes
    from flac_tpu_torch.encode import packer
    from flac_tpu_torch.encode.encoder import StreamEncoder, encode_file
    from flac_tpu_torch.encode.frame_encoder import (
        EncoderConfig, build_frame_encoder, build_frame_encoder_dense,
        build_frame_encoder_parts, max_frame_bytes)
    from flac_tpu_torch.kernels import _build
    from flac_tpu_torch.kernels import compact_stream as cst
    from flac_tpu_torch.kernels import pack_words as pw
    from flac_tpu_torch.kernels import residual_scan as rs
    from flac_tpu_torch.kernels import restore_scan as rr
    from flac_tpu_torch.md5 import MD5Context
    from flac_tpu_torch import replaygain as rg
    from flac_tpu_torch.cli import metaflac
    from flac_tpu_torch.kernels import iir_scan as iir
    from flac_tpu_torch.metadata import Padding, get_tags, parse_metadata

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    os.environ["FLAC_TPU_PACKER"] = "pallas"  # the banded fill, unless a phase says

    # --- 1. env -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    card = f"{kind}, {smi.splitlines()[0].split(',')[-1].strip()}"
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "card": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "native_runtime": _native.available,
          "build_s": build_s,
          "nvcc_s": {k: v["seconds"] for k, v in _build.build_log.items()},
          "ptxas": {k: v["ptxas"] for k, v in _build.build_log.items()}})

    # --- 2./3. the pack kernel, both fills, against the plain versions ------
    def u32(t):
        return t.to(torch.int64) & MASK32

    def tables(words):
        tbl, inv = packer.crc16_word_tables(words)
        return torch.as_tensor(tbl, device=dev), torch.as_tensor(inv, device=dev)

    pcm = make_pcm(SAMPLE_RATE * SECONDS)
    cfg = EncoderConfig.from_level(5, 2, 16, SAMPLE_RATE)
    fields_fn, _ = build_frame_encoder_parts(cfg, device=dev)
    maxwords = max_frame_bytes(cfg, BLOCKSIZE) // 4
    frames = pcm[: (len(pcm) // BLOCKSIZE) * BLOCKSIZE].reshape(-1, BLOCKSIZE, 2)
    # the stream's final partial block, which encode_file packs on its own
    rem = len(pcm) - frames.shape[0] * BLOCKSIZE
    tail_fn, _ = build_frame_encoder_parts(cfg, blocksize=rem, device=dev)
    B = 512
    real = [("level5_batch_64x4096", *fields_fn(frames[:64], np.arange(64))[:2], maxwords),
            (f"level5_partial_1x{rem}",
             *tail_fn(pcm[None, -rem:], np.asarray([frames.shape[0]]))[:2],
             max_frame_bytes(cfg, rem) // 4),
            (f"level5_batch_{B}x{BLOCKSIZE}", *fields_fn(frames[:B], np.arange(B))[:2],
             maxwords)]
    tile_max = pw.max_tile_words()
    big = tiled_case(tile_max)
    tbl5, inv5 = tables(maxwords)

    def pack_phase(merged: bool) -> dict:
        launcher = pw.pack_words_multi if merged else pw.pack_words
        fill_plain = packer.pack_fields_merged if merged else packer.pack_fields
        fill_kernel = packer.pack_fields_merged_kernel if merged else packer.pack_fields_kernel

        def check(name, values, nbits, words, crc, tile_words=None):
            v = torch.as_tensor(values, dtype=torch.int64, device=dev)
            n = torch.as_tensor(nbits, dtype=torch.int32, device=dev)
            if crc:  # the fused mode, as pack() launches it
                tbl, inv = tables(words)
                wp, tp = packer.pack_frames(v, n, words, tbl, inv, merged)
                wk, tk = (packer.pack_frames_kernel(v, n, words, tbl, inv, merged)
                          if tile_words is None
                          else launcher(v, n, words, tbl, inv, tile_words=tile_words))
            else:
                wp, tp = fill_plain(v, n, words)
                wk, tk = (fill_kernel(v, n, words) if tile_words is None
                          else launcher(v, n, words, tile_words=tile_words))
            torch.cuda.synchronize()
            err = int((u32(wk) - u32(wp)).abs().max())
            mode = "fused" if crc else "fill"
            if err or not torch.equal(tk, tp):
                raise AssertionError(f"{launcher.__name__} disagrees on {name} ({mode}, "
                                     f"tile {tile_words}): max err {err}")
            return {"case": name, "mode": mode, "shape": list(v.shape), "maxwords": words,
                    "tiles": -(-words // (tile_words or tile_max)), "max_abs_err": err}

        cases = []
        for tile_words in (None, SMALL_TILE):
            cases += [check(*c, False, tile_words) for c in packer_cases()]
            cases += [check(*c, True, tile_words) for c in crc_slot_cases()]
        for name, v, n, words in real:
            cases += [check(name, v, n, words, False), check(name, v, n, words, True)]
        cases.append(check(*real[0], True, tile_words=1024))
        finishes = pw.crc_finish_launches
        cases.append(check(*big, True))
        if cases[-1]["tiles"] < 3 or pw.crc_finish_launches != finishes + 1:
            raise AssertionError(f"the {big[0]} case did not take the tiled path")

        # times at the main path's shapes: the fused kernel (what pack()
        # launches), its fill-only mode, the plain composition and one
        # index_add_ of the fill's contributions (the library yardstick,
        # which the port never calls)
        timing = {}
        for _, values, nbits, words in (real[2], real[0]):
            nb, nf = values.shape
            idx, src = fill_contributions(values, nbits, words, merged)
            dummy = nb * words

            def library():
                return torch.zeros(dummy + 1, dtype=torch.int64,
                                   device=dev).index_add_(0, idx, src)

            if not torch.equal(library()[:dummy].reshape(nb, words),
                               u32(launcher(values, nbits, words)[0])):
                raise AssertionError("the index_add_ yardstick disagrees with the kernel")
            # values and nbits read once, the words and bit counts written
            # once, tbl read once and one inv entry a frame; the operations
            # are crc16_from_words' bit loops: 16 reduction and 16 multiply
            # steps of 3 int32 operations a word
            nbytes = nb * nf * 12 + nb * words * 4 + nb * 4 + words * 4 + nb * 4
            ops = nb * words * 96
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT32_MACS_PER_S * 1e3
            timing[f"B{nb}"] = {
                "kernel_ms": graph_ms(lambda: launcher(values, nbits, words, tbl5, inv5)),
                "fill_only_ms": graph_ms(lambda: launcher(values, nbits, words)),
                # back to back from Python, the launcher's host work included
                "call_ms": time_ms(lambda: launcher(values, nbits, words, tbl5, inv5)),
                "plain_ms": time_ms(lambda: packer.pack_frames(values, nbits, words, tbl5,
                                                               inv5, merged),
                                    iters=5, warmup=1),
                "library_ms": graph_ms(library),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "bytes_ms": bytes_ms, "int32_ops": ops, "ops_ms": ops_ms,
                "fields": nf, "maxwords": words}
            del idx, src
        torch.cuda.empty_cache()
        phase = {"phase": "kernels_merged" if merged else "kernels", "card": card,
                 "kernel": launcher.__name__, "max_tile_words": tile_max,
                 "cases": cases, "timing": timing}
        emit(phase)
        return phase

    pack_rows = {False: pack_phase(False), True: pack_phase(True)}
    del real, big
    torch.cuda.empty_cache()

    # --- 4. main path: encode_file on the card ------------------------------
    n = len(pcm)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.flac")
        torch.cuda.synchronize()
        pw.launches = cst.launches = 0
        t0 = time.perf_counter()
        stats = encode_file(pcm, SAMPLE_RATE, 16, path, level=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pw.launches
        compact_launches = cst.launches
        with open(path, "rb") as f:
            data = f.read()
    n_full = n // BLOCKSIZE
    full_batches = -(-n_full // 64)  # encode_file's batch_frames
    if launches == 0 or launches != stats.batches:
        raise AssertionError(f"pack kernel launched {launches} times for "
                             f"{stats.batches} frame batches")
    # the dense route compacts each batch of full frames; the final partial
    # frame takes the padded route
    if compact_launches != full_batches:
        raise AssertionError(f"compaction kernel launched {compact_launches} times for "
                             f"{full_batches} batches of full frames")
    if stats.frames != n_full + 1 or stats.samples != n:
        raise AssertionError(f"encoded {stats.frames} frames / {stats.samples} samples")
    if hashlib.sha256(data).hexdigest() != SHA256_60S_16BIT_L5:
        raise AssertionError("the 60 s -5 stream differs from the padded route's")
    t1 = time.perf_counter()
    out, si, dframes = decode_bytes(data)  # checks CRC-8, CRC-16 and MD5
    decode_s = time.perf_counter() - t1
    if si.md5sum == b"\x00" * 16 or not np.array_equal(out, pcm):
        raise AssertionError("decoded PCM differs from the input")

    # the first batch again, on the CPU and on the card
    diff_frames, diff_bytes = frames_differing(cfg, frames[:64], dev)
    if diff_frames:
        raise AssertionError(f"{diff_frames} of the first 64 frames differ between the "
                             f"CPU and the card ({diff_bytes} bytes)")

    from torch.profiler import ProfilerActivity, profile
    fnos_64 = np.arange(64)

    def stage_batch(impl: str, trace_pack: bool = True, cfg=cfg, frames=frames) -> dict:
        """Where one 64-frame batch of `frames` (encoded with `cfg`) spends
        its time with the word fill `impl`: the two device stages and the
        host's MD5, copy back and emit on the host clock, for the dense
        route (the compacted words, _emit_dense) and for the padded one
        (the word matrix, _emit, the CPU's route) at the same point; the
        device's busy time and event count under the profiler, and
        (trace_pack) pack() alone under the profiler, where it must be one
        kernel and no other device event."""
        fields_gpu, pack_gpu = build_frame_encoder_parts(cfg, device=dev, packer_impl=impl)
        enc = build_frame_encoder(cfg, device=dev, packer_impl=impl)
        enc_dense = build_frame_encoder_dense(cfg, device=dev, packer_impl=impl)
        emitter = StreamEncoder(cfg, io.BytesIO(), device=dev)
        chunk = frames[:64].reshape(-1, cfg.channels)

        def staged():
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            v, nb, _ = fields_gpu(frames[:64], fnos_64)
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            pack_gpu(v, nb)
            torch.cuda.synchronize()
            return (t_b - t_a) * 1e3, (time.perf_counter() - t_b) * 1e3

        def host_stages():
            # a fresh sink for each emit: writing into one that has grown
            # over the runs adds its reallocations to whichever emit hits them
            padded_sink, dense_sink = io.BytesIO(), io.BytesIO()
            t_a = time.perf_counter()
            MD5Context().accumulate(chunk, cfg.bits_per_sample)
            t_b = time.perf_counter()
            w, tb, _ = enc(frames[:64], fnos_64)
            torch.cuda.synchronize()
            t_c = time.perf_counter()
            wh, th = w.cpu().numpy(), tb.cpu().numpy()
            emitter.out = padded_sink
            t_d = time.perf_counter()
            emitter._emit(wh, th, 64)
            t_e = time.perf_counter()
            stream, total, tb, _ = enc_dense(frames[:64], fnos_64)
            torch.cuda.synchronize()
            t_f = time.perf_counter()
            th = tb.cpu().numpy()
            total = int(total)
            sh = stream[: (total + 3) // 4].cpu().numpy()
            emitter.out = dense_sink
            t_g = time.perf_counter()
            emitter._emit_dense(sh, total, th, 64)
            t_h = time.perf_counter()
            return tuple((y - x) * 1e3 for x, y in
                         ((t_a, t_b), (t_b, t_c), (t_c, t_d), (t_d, t_e),
                          (t_e, t_f), (t_f, t_g), (t_g, t_h))) + (len(sh),)

        staged()
        host_stages()
        runs = [(staged(), host_stages()) for _ in range(7)]  # interleaved
        fields_ms, pack_ms = (float(np.median(s)) for s in zip(*[a for a, _ in runs]))
        (md5_ms, batch_ms, copy_ms, emit_ms, dense_batch_ms, dense_copy_ms,
         dense_emit_ms, dense_words) = (float(np.median(s))
                                        for s in zip(*[b for _, b in runs]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_a = time.perf_counter()
            enc(frames[:64], fnos_64)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t_a) * 1e3
        # the device's own events (kernels, copies, fills); summing
        # key_averages' self device times instead would count each kernel
        # under its op too
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = busy_ms(spans) if spans else None  # None: the trace saw no device
        stages = {"fields_ms": fields_ms, "pack_ms": pack_ms, "encode_wall_ms": batch_ms,
                  "host_md5_ms": md5_ms, "host_copy_back_ms": copy_ms,
                  "host_emit_ms": emit_ms, "dense_encode_wall_ms": dense_batch_ms,
                  "dense_copy_back_ms": dense_copy_ms, "dense_emit_ms": dense_emit_ms,
                  "dense_copy_back_words": int(dense_words),
                  "padded_copy_back_words": 64 * max_frame_bytes(cfg, BLOCKSIZE) // 4,
                  "profiled_wall_ms": profiled_ms,
                  "device_busy_ms": device_ms, "device_events": len(spans),
                  # busy time over the unprofiled wall; the profiled wall
                  # gives an upper reading
                  "device_idle_share": (None if device_ms is None
                                        else 1 - device_ms / batch_ms),
                  "device_idle_share_profiled": (None if device_ms is None
                                                 else 1 - device_ms / profiled_ms)}
        if not trace_pack:
            return stages
        v, nb, _ = fields_gpu(frames[:64], fnos_64)
        torch.cuda.synchronize()

        def pack_trace():
            """Device events of 3 pack() calls, after a warm-up step: the
            trace misses launches made just after it starts."""
            traces = []
            counted = pw.launches + pw.pack_words_multi.launches
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: traces.append(
                             [e.name for e in p.events()  # less the step's own range
                              if e.device_type == torch.autograd.DeviceType.CUDA
                              and not e.name.startswith("ProfilerStep")])) as prof_pack:
                for calls in (1, 3):
                    for _ in range(calls):
                        pack_gpu(v, nb)
                    torch.cuda.synchronize()
                    prof_pack.step()
            if pw.launches + pw.pack_words_multi.launches != counted + 4:
                raise AssertionError(f"pack() with the {impl} fill did not launch once a call")
            return traces[0] if traces else []

        # a trace that saw no device activity at all is a failed reading
        # (pack() launched: the counters say so), and is taken again
        pack_events, sessions = pack_trace(), 1
        while not pack_events and sessions < 3:
            pack_events, sessions = pack_trace(), sessions + 1
        if len(pack_events) != 3 or any("pack_frames_kernel" not in e for e in pack_events):
            raise AssertionError(f"3 pack() calls with the {impl} fill ran {pack_events} "
                                 "on the device, not one pack kernel each")
        return dict(stages, pack_device_events_3_calls=pack_events,
                    pack_trace_sessions=sessions)

    one_batch = stage_batch("pallas")
    # the whole encode again, device activity only: its busy time over the
    # unprofiled run's wall is the run's idle share
    with tempfile.TemporaryDirectory() as tmp, \
            profile(activities=[ProfilerActivity.CUDA]) as prof_run:
        encode_file(pcm, SAMPLE_RATE, 16, os.path.join(tmp, "p.flac"), level=5)
        torch.cuda.synchronize()
    run_spans = [(e.time_range.start, e.time_range.end) for e in prof_run.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    run_busy_s = busy_ms(run_spans) / 1e3 if run_spans else None
    emit({"phase": "encode", "card": card, "seconds_of_audio": SECONDS,
          "samples_per_channel": n, "frames": stats.frames,
          "batches": stats.batches, "pack_kernel_launches": launches,
          "compact_stream_launches": compact_launches, "route": "dense",
          "wall_s": wall, "msamples_per_s_per_channel": n / wall / 1e6,
          "compression_ratio": len(data) / (n * 2 * 2), "bytes": len(data),
          "decode_s": decode_s, "lossless": True,
          "run_device_busy_s": run_busy_s, "run_device_events": len(run_spans),
          "run_device_idle_share": (None if run_busy_s is None
                                    else 1 - run_busy_s / wall),
          "cpu_vs_gpu_first_batch": {"frames_differing": diff_frames,
                                     "bytes_differing": diff_bytes},
          "stream_sha256": hashlib.sha256(data).hexdigest(),
          "one_batch_64": one_batch})

    # --- 5. the merged fill with verify on the card ------------------------
    os.environ["FLAC_TPU_PACKER"] = "merged"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "merged.flac")
            torch.cuda.synchronize()
            pw.pack_words_multi.launches = rs.launches = rr.launches = cst.launches = 0
            t0 = time.perf_counter()
            mstats = encode_file(pcm, SAMPLE_RATE, 16, path, level=5, verify=True)
            torch.cuda.synchronize()
            merged_wall = time.perf_counter() - t0
            merged_launches = pw.pack_words_multi.launches
            merged_compact_launches = cst.launches
            verify_launches = (rs.launches, rr.launches)
            with open(path, "rb") as f:
                merged_data = f.read()
            # the same without verify: what the merged fill costs alone
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_file(pcm, SAMPLE_RATE, 16, os.path.join(tmp, "nv.flac"), level=5)
            torch.cuda.synchronize()
            merged_noverify_wall = time.perf_counter() - t0
    finally:
        os.environ["FLAC_TPU_PACKER"] = "pallas"
    # the banded encode again at this point of the run: the gap between the
    # two fills' walls is then the fill's, not the process's state
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_file(pcm, SAMPLE_RATE, 16, os.path.join(tmp, "b.flac"), level=5)
        torch.cuda.synchronize()
        banded_again_wall = time.perf_counter() - t0
    if merged_data != data:
        raise AssertionError("the merged fill's stream differs from the banded one")
    if merged_launches != mstats.batches:
        raise AssertionError(f"pack_words_multi launched {merged_launches} times for "
                             f"{mstats.batches} batches")
    if merged_compact_launches != full_batches:
        raise AssertionError(f"the merged encode compacted {merged_compact_launches} "
                             f"batches of {full_batches}")
    if verify_launches != (2 * full_batches, full_batches):
        raise AssertionError(f"verify launched the decode kernels {verify_launches} "
                             f"times for {full_batches} batches of 2 channels")
    emit({"phase": "encode_merged", "card": card, "batches": mstats.batches,
          "pack_words_multi_launches": merged_launches,
          "compact_stream_launches": merged_compact_launches,
          "verify_subframe_scan_launches": verify_launches[0],
          "verify_restore_scan_launches": verify_launches[1],
          "bytes_equal_banded": True, "verify": "passed", "wall_s": merged_wall,
          "wall_s_without_verify": merged_noverify_wall,
          "banded_wall_s_again": banded_again_wall,
          "msamples_per_s_per_channel": n / merged_wall / 1e6,
          "one_batch_64": stage_batch("merged"),
          "one_batch_64_banded_again": stage_batch("pallas", trace_pack=False)})

    # --- 6. decode kernels against their plain versions -----------------------
    d8 = np.frombuffer(data, np.uint8)
    blocks, audio_offset = parse_metadata(data)
    offsets = st.index_frames(d8, audio_offset, blocks[0])
    if offsets is None or len(offsets) != n_full:
        raise AssertionError("the frame index of the 60 s stream is wrong")
    words = torch.as_tensor(fd.bytes_to_words(d8, bucket=True), device=dev)
    geom = fd.DecoderGeometry(blocksize=BLOCKSIZE, channels=2, bits_per_sample=16,
                              sample_rate=SAMPLE_RATE, max_lpc_order=DECODE_MAXORD)
    starts = torch.as_tensor(offsets[:DECODE_B] * 8, device=dev)

    def err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    def scan_err(got, ref):
        """Largest difference over every output of a subframe scan."""
        if list(got[0]) != list(ref[0]):
            raise AssertionError("the subframe scan's fields differ from the plain parse's")
        pairs = [(got[0][k], ref[0][k]) for k in ref[0]] + list(zip(got[1:], ref[1:]))
        if any(a.shape != b.shape or a.dtype != b.dtype for a, b in pairs):
            raise AssertionError("a subframe-scan output differs in shape or dtype")
        return max(err(a, b) for a, b in pairs)

    def stack_rows(rows):
        return [torch.cat(parts) for parts in zip(*rows)]

    dcases, scan_inputs, rows = [], [], []
    pos, assignment, _ = fd.read_frame_header(words, starts, geom.header_ext_bits, 2)
    for c in range(2):
        cbps = fd.side_channel_bps(assignment, c, 16, 2)
        got = rs.subframe_scan(words, pos, cbps, BLOCKSIZE, DECODE_MAXORD)
        ref = fd.subframe_scan(words, pos, cbps, BLOCKSIZE, DECODE_MAXORD)
        torch.cuda.synchronize()
        dcases.append({"case": f"stream_{DECODE_B}x{BLOCKSIZE}_channel{c}",
                       "subframe_scan_max_abs_err": scan_err(got, ref),
                       "overflow_frames": int(got[3].sum())})
        scan_inputs.append((pos, cbps, got[2]))
        rows.append((got[1], *fd.restore_inputs(got[0], DECODE_MAXORD)))
        pos = got[2]
    rargs = (*stack_rows(rows), BLOCKSIZE, DECODE_MAXORD)
    xk, xp = rr.restore_scan(*rargs), fd.restore_scan(*rargs)
    torch.cuda.synchronize()
    dcases.append({"case": f"stream_stacked_{2 * DECODE_B}x{BLOCKSIZE}",
                   "restore_scan_max_abs_err": err(xk, xp)})
    del xk, xp
    for name, w in fold_guard_words().items():
        args = (torch.as_tensor(w, device=dev), torch.zeros(1, dtype=torch.int64, device=dev),
                torch.full((1,), 16, dtype=torch.int64, device=dev), 8, DECODE_MAXORD)
        got, ref = rs.subframe_scan(*args), fd.subframe_scan(*args)
        torch.cuda.synchronize()
        if bool(got[3][0]) != (name != "fold_exact") or not bool(got[0]["is_fixed"][0]):
            raise AssertionError(f"the scan's overflow flag or parse is wrong on {name}")
        dcases.append({"case": name, "subframe_scan_max_abs_err": scan_err(got, ref),
                       "ovf": bool(got[3][0])})
    rw, rstarts, rcbps = random_subframes()
    rargs_rnd = (torch.as_tensor(rw, device=dev), torch.as_tensor(rstarts, device=dev),
                 torch.as_tensor(rcbps, device=dev), BLOCKSIZE, DECODE_MAXORD)
    got, ref = rs.subframe_scan(*rargs_rnd), fd.subframe_scan(*rargs_rnd)
    torch.cuda.synchronize()
    sub = ref[0]
    dcases.append({"case": f"random_{len(rstarts)}x{BLOCKSIZE}",
                   "subframe_scan_max_abs_err": scan_err(got, ref),
                   "overflow_frames": int(got[3].sum()),
                   "types": {k: int(sub[k].sum()) for k in
                             ("is_const", "is_verb", "is_fixed", "is_lpc")},
                   "wasted_over_width": int((sub["wasted"] > torch.as_tensor(
                       rcbps, device=dev)).sum()),
                   "negative_pos": int((sub["pos"] < 0).sum() + (ref[2] < 0).sum())})
    rnd = (got[1], *fd.restore_inputs(got[0], DECODE_MAXORD), BLOCKSIZE, DECODE_MAXORD)
    xk, xp = rr.restore_scan(*rnd), fd.restore_scan(*rnd)
    torch.cuda.synchronize()
    dcases[-1]["restore_scan_max_abs_err"] = err(xk, xp)
    del got, ref, sub, rnd, xk, xp
    for cse in dcases:
        errs = [v for k, v in cse.items() if k.endswith("max_abs_err")]
        if any(errs):
            raise AssertionError(f"a decode kernel disagrees on {cse}")
    # times: the scan on channel 0 of the 512 real frames, the restore on
    # both channels' rows stacked (one launch, as the frame decoder runs it)
    pos0, cbps0, end0 = scan_inputs[0]
    sargs = (words, pos0, cbps0, BLOCKSIZE, DECODE_MAXORD)
    scan_ms = time_ms(lambda: rs.subframe_scan(*sargs))
    scan_plain_ms = time_ms(lambda: fd.subframe_scan(*sargs), iters=1, warmup=0)
    restore_ms = time_ms(lambda: rr.restore_scan(*rargs))
    restore_plain_ms = time_ms(lambda: fd.restore_scan(*rargs), iters=2, warmup=0)
    # subframe scan: the subframe's bits from its first header bit, res
    # written, pos and cbps read, and the parse fields (9 int64, 5 bool,
    # warmup and coefficients), end and ovf written once
    sub_bytes = int(((end0 - pos0).sum() + 7) // 8)
    scan_bytes = (sub_bytes + DECODE_B * BLOCKSIZE * 4
                  + DECODE_B * (16 + 9 * 8 + 5 + 2 * DECODE_MAXORD * 8 + 9))
    scan_bound_ms = scan_bytes / HBM_BYTES_PER_S * 1e3
    # restore: res read, x written, coefficients and warmup read once; the
    # multiply-adds these rows need: (T - order) * order per coded row
    res_all, coeffs_all, order_all, _, _, coded_all, _, _ = rargs
    n_rows = res_all.shape[0]
    n_taps = torch.clamp(order_all, 0, DECODE_MAXORD)
    restore_macs = int(torch.where(coded_all, (BLOCKSIZE - order_all).clamp(min=0) * n_taps,
                                   0).sum())
    restore_bytes = (n_rows * BLOCKSIZE * (4 + 8) + n_rows * DECODE_MAXORD * 16
                     + n_rows * 17)
    restore_bytes_ms = restore_bytes / HBM_BYTES_PER_S * 1e3
    restore_ops_ms = restore_macs / INT32_MACS_PER_S * 1e3
    restore_bound_ms = max(restore_bytes_ms, restore_ops_ms)
    del scan_inputs, rows, rargs, res_all, coeffs_all
    torch.cuda.empty_cache()
    emit({"phase": "kernels_decode", "card": card, "cases": dcases,
          "timing_shape": {"B": DECODE_B, "T": BLOCKSIZE, "maxord": DECODE_MAXORD,
                           "restore_rows": n_rows},
          "subframe_scan": {"kernel_ms": scan_ms, "plain_ms": scan_plain_ms,
                            "bound_ms": scan_bound_ms, "bytes": scan_bytes,
                            "subframe_bytes": sub_bytes},
          "restore_scan": {"kernel_ms": restore_ms, "plain_ms": restore_plain_ms,
                           "bound_ms": restore_bound_ms, "bytes": restore_bytes,
                           "bytes_ms": restore_bytes_ms, "macs": restore_macs,
                           "macs_ms": restore_ops_ms}})

    # --- 7. decode_bytes_device on the card ------------------------------------
    n_batches = -(-n_full // DECODE_B)
    torch.cuda.synchronize()
    rs.launches = rr.launches = 0
    t0 = time.perf_counter()
    out, _si, info = st.decode_bytes_device(data)
    torch.cuda.synchronize()
    decode_wall = time.perf_counter() - t0
    decode_launches = (rs.launches, rr.launches)
    if not np.array_equal(out, pcm):
        raise AssertionError("decode_bytes_device did not return the input")
    if info["path"] != "device" or info["errors"] or info["frames"] != n_full + 1:
        raise AssertionError(f"decode_bytes_device: {info}")
    if info["host_frames"] != 1 or info["overflow_frames"] != 0:
        raise AssertionError(f"frames decoded on the host: {info}")
    if decode_launches != (2 * n_batches, n_batches):
        raise AssertionError(f"decode kernels launched {decode_launches} times for "
                             f"{n_batches} batches of 2 channels")
    blocks_out = list(st.StreamDecoder(data).iter_blocks())
    if not np.array_equal(np.concatenate(blocks_out), pcm):
        raise AssertionError("iter_blocks differs from the input")
    # the host clock varies from call to call: the decode again, 5 times
    decode_walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.decode_bytes_device(data)
        torch.cuda.synchronize()
        decode_walls.append(time.perf_counter() - t0)

    # one 512-frame batch by stage, host clock, device synchronised after each
    dec = fd.build_frame_decoder(geom, dev)

    def decode_stages():
        out = {}
        t_a = time.perf_counter()
        st.index_frames(d8, audio_offset, blocks[0])
        t_b = time.perf_counter()
        w = torch.as_tensor(fd.bytes_to_words(d8, bucket=True), device=dev)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        p, a, _ = fd.read_frame_header(w, starts, geom.header_ext_bits, 2)
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        batch_rows = []
        for c in range(2):
            sub, r, p, _ = fd.subframe_scan_kernel(
                w, p, fd.side_channel_bps(a, c, 16, 2), BLOCKSIZE, DECODE_MAXORD)
            batch_rows.append((r, *fd.restore_inputs(sub, DECODE_MAXORD)))
        torch.cuda.synchronize()
        t_1 = time.perf_counter()
        fd.restore_scan_kernel(*stack_rows(batch_rows), BLOCKSIZE, DECODE_MAXORD)
        torch.cuda.synchronize()
        t_2 = time.perf_counter()
        pcm_b, ends_b, _ = dec(w, starts)
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        pcm_h = pcm_b.cpu().numpy().astype(np.int32)
        ends_h = ends_b.cpu().numpy() // 8
        t_f = time.perf_counter()
        st.check_frame_crc16(data, d8, offsets[:DECODE_B], ends_h)
        t_g = time.perf_counter()
        MD5Context().accumulate(pcm_h.reshape(-1, 2), 16)
        t_h = time.perf_counter()
        out.update(index_ms=(t_b - t_a) * 1e3, upload_ms=(t_c - t_b) * 1e3,
                   frame_header_ms=(t_0 - t_c) * 1e3,
                   subframe_scan_ms=(t_1 - t_0) * 1e3,
                   restore_scan_ms=(t_2 - t_1) * 1e3, batch_decode_ms=(t_e - t_2) * 1e3,
                   copy_back_ms=(t_f - t_e) * 1e3, crc16_ms=(t_g - t_f) * 1e3,
                   md5_ms=(t_h - t_g) * 1e3)
        return out

    decode_stages()
    runs = [decode_stages() for _ in range(5)]
    stages = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    from torch.profiler import ProfilerActivity, profile
    # one batch decode under the profiler: the device's busy time and its
    # time in each kernel
    words_dev = torch.as_tensor(fd.bytes_to_words(d8, bucket=True), device=dev)
    dec(words_dev, starts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_b:
        dec(words_dev, starts)
        torch.cuda.synchronize()
    b_events = [e for e in prof_b.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    batch_kernel_ms: dict = {}
    for e in b_events:
        if "subframe_scan" in e.name or "restore_scan" in e.name:
            key = "subframe_scan" if "subframe_scan" in e.name else "restore_scan"
            batch_kernel_ms[key] = batch_kernel_ms.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    stages["device_busy_ms"] = (busy_ms([(e.time_range.start, e.time_range.end)
                                         for e in b_events]) if b_events else None)
    stages["device_events"] = len(b_events)
    stages["device_kernel_ms"] = batch_kernel_ms
    del words_dev
    with profile(activities=[ProfilerActivity.CUDA]) as prof_dec:
        st.decode_bytes_device(data)
        torch.cuda.synchronize()
    dec_spans = [(e.time_range.start, e.time_range.end) for e in prof_dec.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    dec_busy_s = busy_ms(dec_spans) / 1e3 if dec_spans else None
    emit({"phase": "decode", "card": card, "frames": info["frames"],
          "batches": n_batches, "path": info["path"],
          "host_frames": info["host_frames"], "overflow_frames": info["overflow_frames"],
          "subframe_scan_launches": decode_launches[0],
          "restore_scan_launches": decode_launches[1], "lossless": True,
          "iter_blocks_equal": True, "wall_s": decode_wall,
          "wall_s_repeats": decode_walls,
          "wall_s_median_of_repeats": float(np.median(decode_walls)),
          "msamples_per_s_per_channel": n / decode_wall / 1e6,
          "run_device_busy_s": dec_busy_s, "run_device_events": len(dec_spans),
          "run_device_idle_share": (None if dec_busy_s is None
                                    else 1 - dec_busy_s / decode_wall),
          "one_batch_512": stages})

    # --- 8. encode_hires: 24-bit/96 kHz at -8 on the card ----------------------
    pcm24 = make_pcm(HIRES_RATE * HIRES_SECONDS, seed=24, rate=HIRES_RATE, bits=24)
    n24 = len(pcm24)
    n_full24 = n24 // BLOCKSIZE
    frames24 = pcm24[: n_full24 * BLOCKSIZE].reshape(-1, BLOCKSIZE, 2)
    cfg8 = EncoderConfig.from_level(8, 2, 24, HIRES_RATE)
    full_batches24 = -(-n_full24 // 64)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        pw.launches = rs.launches = rs.wide_launches = rr.launches = cst.launches = 0
        t0 = time.perf_counter()
        hstats = encode_file(pcm24, HIRES_RATE, 24, os.path.join(tmp, "h.flac"), level=8,
                             verify=True)
        torch.cuda.synchronize()
        hires_wall = time.perf_counter() - t0
        hires_launches = (pw.launches, rs.launches, rs.wide_launches, rr.launches)
        hires_compact_launches = cst.launches
        with open(os.path.join(tmp, "h.flac"), "rb") as f:
            data24 = f.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_file(pcm24, HIRES_RATE, 24, os.path.join(tmp, "h2.flac"), level=8)
        torch.cuda.synchronize()
        hires_noverify_wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "h2.flac"), "rb") as f:
            if f.read() != data24:
                raise AssertionError("the 24-bit -8 stream differs without verify")
    if hstats.frames != n_full24 + 1 or hstats.samples != n24:
        raise AssertionError(f"hi-res encode: {hstats.frames} frames / {hstats.samples} samples")
    # one pack launch a batch; the verifier's narrow scan once a channel and
    # the restore once a batch of full frames
    if hires_launches != (hstats.batches, 2 * full_batches24, 0, full_batches24) \
            or hires_compact_launches != full_batches24:
        raise AssertionError(f"hi-res encode launched (pack, scan, wide scan, restore) "
                             f"{hires_launches} and {hires_compact_launches} compactions "
                             f"for {hstats.batches} batches")
    if hashlib.sha256(data24).hexdigest() != SHA256_30S_24BIT_L8:
        raise AssertionError("the 30 s 24-bit -8 stream differs from the padded "
                             "route's")
    out24, si24, _ = decode_bytes(data24)  # CRC-8, CRC-16 and MD5 checked
    if si24.md5sum == b"\x00" * 16 or not np.array_equal(out24, pcm24):
        raise AssertionError("the 24-bit -8 stream does not decode to its input")
    diff24 = frames_differing(cfg8, frames24[:16], dev)
    if diff24[0]:
        raise AssertionError(f"{diff24[0]} of the first 16 24-bit -8 frames differ "
                             f"between the CPU and the card ({diff24[1]} bytes)")
    one_batch_24 = stage_batch("pallas", trace_pack=False, cfg=cfg8, frames=frames24)
    # -p and escape coding on a signal with full-scale bursts
    pcm_pe = burst_pcm(HIRES_RATE * PE_SECONDS, 24, seed=25)
    cfg_pe = EncoderConfig.from_level(8, 2, 24, HIRES_RATE, do_qlp_coeff_prec_search=True,
                                      do_escape_coding=True)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        pw.launches = 0
        t0 = time.perf_counter()
        pstats = encode_file(pcm_pe, HIRES_RATE, 24, os.path.join(tmp, "pe.flac"), level=8,
                             do_qlp_coeff_prec_search=True, do_escape_coding=True)
        torch.cuda.synchronize()
        pe_wall = time.perf_counter() - t0
        pe_launches = pw.launches
        with open(os.path.join(tmp, "pe.flac"), "rb") as f:
            data_pe = f.read()
    pe_pcm, pe_frames = HostDecoder(data_pe).decode_all()
    escaped = sum(p == -1 for fr in pe_frames for sf in fr.subframes for p in sf.rice_params)
    if not np.array_equal(pe_pcm, pcm_pe) or not np.array_equal(decode_bytes(data_pe)[0],
                                                                 pcm_pe):
        raise AssertionError("the -p / escape stream does not decode to its input")
    if escaped == 0 or pe_launches != pstats.batches:
        raise AssertionError(f"-p / escape encode: {escaped} escaped partitions, "
                             f"{pe_launches} pack launches for {pstats.batches} batches")
    n_full_pe = len(pcm_pe) // BLOCKSIZE
    diff_pe = frames_differing(cfg_pe, pcm_pe[: n_full_pe * BLOCKSIZE].reshape(
        -1, BLOCKSIZE, 2)[:8], dev)
    if diff_pe[0]:
        raise AssertionError(f"{diff_pe[0]} of the first 8 -p / escape frames differ "
                             f"between the CPU and the card ({diff_pe[1]} bytes)")
    emit({"phase": "encode_hires", "card": card, "seconds_of_audio": HIRES_SECONDS,
          "sample_rate": HIRES_RATE, "bits_per_sample": 24, "level": 8,
          "samples_per_channel": n24, "frames": hstats.frames, "batches": hstats.batches,
          "pack_kernel_launches": hires_launches[0],
          "compact_stream_launches": hires_compact_launches,
          "verify_subframe_scan_launches": hires_launches[1],
          "verify_restore_scan_launches": hires_launches[3], "verify": "passed",
          "wall_s": hires_wall, "wall_s_without_verify": hires_noverify_wall,
          "msamples_per_s_per_channel": n24 / hires_wall / 1e6,
          "compression_ratio": len(data24) / (n24 * 2 * 3), "bytes": len(data24),
          "lossless": True, "bytes_equal_without_verify": True,
          "cpu_vs_gpu_first_16": {"frames_differing": diff24[0], "bytes_differing": diff24[1]},
          "stream_sha256": hashlib.sha256(data24).hexdigest(),
          "one_batch_64": one_batch_24,
          "p_escape": {"seconds_of_audio": PE_SECONDS, "frames": pstats.frames,
                       "batches": pstats.batches, "pack_kernel_launches": pe_launches,
                       "wall_s": pe_wall, "bytes": len(data_pe),
                       "escaped_partitions": escaped, "lossless": True,
                       "cpu_vs_gpu_first_8": {"frames_differing": diff_pe[0],
                                              "bytes_differing": diff_pe[1]}}})

    # --- 9. decode_hires: the 24-bit stream on the card ------------------------
    n_batches24 = -(-n_full24 // DECODE_B)
    torch.cuda.synchronize()
    rs.launches = rs.wide_launches = rr.launches = 0
    t0 = time.perf_counter()
    dout24, _si, dinfo24 = st.decode_bytes_device(data24)
    torch.cuda.synchronize()
    dwall24 = time.perf_counter() - t0
    dlaunch24 = (rs.launches, rs.wide_launches, rr.launches)
    if not np.array_equal(dout24, pcm24):
        raise AssertionError("decode_bytes_device did not return the 24-bit input")
    if dinfo24["path"] != "device" or dinfo24["errors"] or dinfo24["frames"] != n_full24 + 1:
        raise AssertionError(f"decode_bytes_device (24-bit): {dinfo24}")
    if dinfo24["host_frames"] != 1 + dinfo24["overflow_frames"]:
        raise AssertionError(f"24-bit frames on the host: {dinfo24}")
    if dlaunch24 != (2 * n_batches24, 0, n_batches24):
        raise AssertionError(f"24-bit decode launched (scan, wide scan, restore) "
                             f"{dlaunch24} for {n_batches24} batches of 2 channels")
    dwalls24 = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.decode_bytes_device(data24)
        torch.cuda.synchronize()
        dwalls24.append(time.perf_counter() - t0)
    # the kernels at the new widths against their plain versions: the narrow
    # scan on 24-bit RICE2 frames with a 25-bit side channel, the restore at
    # order 12 (its W = 16 instantiation), the pack kernel on one level-8
    # 24-bit batch
    d824 = np.frombuffer(data24, np.uint8)
    blocks24, ao24 = parse_metadata(data24)
    offsets24 = st.index_frames(d824, ao24, blocks24[0])
    words24 = torch.as_tensor(fd.bytes_to_words(d824, bucket=True), device=dev)
    geom24 = fd.DecoderGeometry(blocksize=BLOCKSIZE, channels=2, bits_per_sample=24,
                                sample_rate=HIRES_RATE, max_lpc_order=DECODE_MAXORD)
    starts24 = torch.as_tensor(offsets24[:DECODE_B] * 8, device=dev)
    pos, assignment, _ = fd.read_frame_header(words24, starts24, geom24.header_ext_bits, 2)
    rows24 = []
    for c in range(2):
        cbps = fd.side_channel_bps(assignment, c, 24, 2)
        got = rs.subframe_scan(words24, pos, cbps, BLOCKSIZE, DECODE_MAXORD)
        ref = fd.subframe_scan(words24, pos, cbps, BLOCKSIZE, DECODE_MAXORD)
        torch.cuda.synchronize()
        dcases.append({"case": f"hires24_{DECODE_B}x{BLOCKSIZE}_channel{c}",
                       "subframe_scan_max_abs_err": scan_err(got, ref),
                       "overflow_frames": int(got[3].sum()),
                       "max_side_bps": int(cbps.max())})
        rows24.append((got[1], *fd.restore_inputs(got[0], DECODE_MAXORD)))
        pos = got[2]
    rargs24 = (*stack_rows(rows24), BLOCKSIZE, DECODE_MAXORD)
    coded_orders = rargs24[2][rargs24[5]]
    if not 8 < int(coded_orders.max()) <= 16:
        raise AssertionError("the 24-bit -8 frames did not reach the restore's W = 16 taps")
    xk, xp = rr.restore_scan(*rargs24), fd.restore_scan(*rargs24)
    torch.cuda.synchronize()
    dcases.append({"case": f"hires24_stacked_{2 * DECODE_B}x{BLOCKSIZE}",
                   "restore_scan_max_abs_err": err(xk, xp),
                   "max_order": int(coded_orders.max())})
    del xk, xp, rows24, rargs24
    fields8, _ = build_frame_encoder_parts(cfg8, device=dev)
    v8, nb8, _ = fields8(frames24[:64], np.arange(len(frames24[:64])))
    words8 = max_frame_bytes(cfg8, BLOCKSIZE) // 4
    tbl8, inv8 = tables(words8)
    wp, tp = packer.pack_frames(v8, nb8, words8, tbl8, inv8, False)
    wk, tk = packer.pack_frames_kernel(v8, nb8, words8, tbl8, inv8, False)
    torch.cuda.synchronize()
    perr = int((u32(wk) - u32(wp)).abs().max()) + int((tk != tp).sum())
    pack_rows[False]["cases"].append({"case": "level8_24bit_batch_64x4096", "mode": "fused",
                                      "shape": list(v8.shape), "maxwords": words8,
                                      "max_abs_err": perr})
    del v8, nb8, wp, wk
    for cse in dcases:
        if any(v for k, v in cse.items() if k.endswith("max_abs_err")):
            raise AssertionError(f"a decode kernel disagrees on {cse}")
    if perr:
        raise AssertionError("the pack kernel disagrees on a level-8 24-bit batch")
    emit({"phase": "decode_hires", "card": card, "frames": dinfo24["frames"],
          "batches": n_batches24, "path": dinfo24["path"],
          "host_frames": dinfo24["host_frames"], "overflow_frames": dinfo24["overflow_frames"],
          "subframe_scan_launches": dlaunch24[0], "restore_scan_launches": dlaunch24[2],
          "lossless": True, "wall_s": dwall24, "wall_s_repeats": dwalls24,
          "wall_s_median_of_repeats": float(np.median(dwalls24)),
          "msamples_per_s_per_channel": n24 / float(np.median(dwalls24)) / 1e6,
          "kernel_cases": dcases[-3:], "pack_level8_24bit_max_abs_err": perr})

    # --- 10. wide: 28- and 32-bit streams through the wide scan ----------------
    wide_rows, wide_streams = {}, {}
    wide_decode_launches = 0
    for bps in (28, 32):
        # noise of sigma 2^18 at both widths: the wide scan refills 96 bits a
        # step of 4 samples, so residuals of more than about 22 bits (32-bit
        # noise scaled as at 16 bits) run its window dry; it flags those
        # frames, which verify compares all the same (ROADMAP queue 3)
        pcm_w = make_pcm(SAMPLE_RATE * WIDE_SECONDS, seed=bps, bits=bps, sigma=2.0 ** 18)
        nw_ = len(pcm_w)
        n_full_w = nw_ // BLOCKSIZE
        full_batches_w = -(-n_full_w // 64)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            pw.launches = rs.launches = rs.wide_launches = rr.launches = cst.launches = 0
            t0 = time.perf_counter()
            wstats = encode_file(pcm_w, SAMPLE_RATE, bps, os.path.join(tmp, "w.flac"),
                                 level=5, verify=True)
            torch.cuda.synchronize()
            wwall = time.perf_counter() - t0
            wlaunch = (pw.launches, rs.launches, rs.wide_launches, rr.launches,
                       cst.launches)
            with open(os.path.join(tmp, "w.flac"), "rb") as f:
                data_w = f.read()
        if wlaunch != (wstats.batches, 0, 2 * full_batches_w, full_batches_w,
                       full_batches_w):
            raise AssertionError(f"{bps}-bit encode launched (pack, scan, wide scan, "
                                 f"restore, compaction) {wlaunch} for {wstats.batches} "
                                 "batches")
        if not np.array_equal(decode_bytes(data_w)[0], pcm_w):
            raise AssertionError(f"the {bps}-bit stream does not decode to its input")
        n_batches_w = -(-n_full_w // DECODE_B)
        torch.cuda.synchronize()
        rs.launches = rs.wide_launches = rr.launches = 0
        t0 = time.perf_counter()
        dout_w, _si, dinfo_w = st.decode_bytes_device(data_w)
        torch.cuda.synchronize()
        dwall_w = time.perf_counter() - t0
        dlaunch_w = (rs.launches, rs.wide_launches, rr.launches)
        if not np.array_equal(dout_w, pcm_w) or dinfo_w["path"] != "device" \
                or dinfo_w["errors"] or dinfo_w["frames"] != n_full_w + 1:
            raise AssertionError(f"decode_bytes_device ({bps}-bit): {dinfo_w}")
        if dlaunch_w != (0, 2 * n_batches_w, n_batches_w):
            raise AssertionError(f"{bps}-bit decode launched (scan, wide scan, restore) "
                                 f"{dlaunch_w} for {n_batches_w} batches of 2 channels")
        wide_decode_launches += dlaunch_w[1]
        wide_streams[bps] = data_w
        wide_rows[bps] = {"seconds_of_audio": WIDE_SECONDS, "frames": wstats.frames,
                          "batches": wstats.batches, "pack_kernel_launches": wlaunch[0],
                          "verify_wide_scan_launches": wlaunch[2],
                          "verify_restore_scan_launches": wlaunch[3],
                          "compact_stream_launches": wlaunch[4], "verify": "passed",
                          "encode_wall_s": wwall, "bytes": len(data_w),
                          "compression_ratio": len(data_w) / (nw_ * 2 * bps / 8),
                          "decode_wall_s": dwall_w, "decode_path": dinfo_w["path"],
                          "host_frames": dinfo_w["host_frames"],
                          "overflow_frames": dinfo_w["overflow_frames"],
                          "wide_scan_launches": dlaunch_w[1],
                          "restore_scan_launches": dlaunch_w[2], "lossless": True,
                          "stream_sha256": hashlib.sha256(data_w).hexdigest()}
    emit({"phase": "wide", "card": card, "streams": {str(k): v for k, v in wide_rows.items()}})

    # --- 11. kernels_wide: the wide scan kernel against its plain version ------
    wcases = []

    def wide_check(name, words_t, pos_t, cbps_t, T, timed=False):
        """The wide kernel against wide_residual_scan's composition on every
        output; returns the kernel's outputs and the plain call's seconds."""
        got = rs.subframe_scan(words_t, pos_t, cbps_t, T, DECODE_MAXORD, wide=True)
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        ref = fd.subframe_scan(words_t, pos_t, cbps_t, T, DECODE_MAXORD, wide=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t_a
        wcases.append({"case": name, "subframe_scan_max_abs_err": scan_err(got, ref),
                       "overflow_frames": int(got[3].sum())})
        return got, plain_s

    # the first 512 frames of phase 4's 16-bit stream, read wide
    pos, assignment, _ = fd.read_frame_header(words, starts, geom.header_ext_bits, 2)
    rows16, wide_timing = [], []  # (pos, cbps, end, plain seconds) a channel
    for c in range(2):
        cbps = fd.side_channel_bps(assignment, c, 16, 2)
        got, plain_s = wide_check(f"stream16_{DECODE_B}x{BLOCKSIZE}_channel{c}", words,
                                  pos, cbps, BLOCKSIZE)
        wide_timing.append((pos, cbps, got[2], plain_s))
        rows16.append((got[1], *fd.restore_inputs(got[0], DECODE_MAXORD)))
        pos = got[2]
    rargs_w = (*stack_rows(rows16), BLOCKSIZE, DECODE_MAXORD)
    xk, xp = rr.restore_scan(*rargs_w), fd.restore_scan(*rargs_w)
    torch.cuda.synchronize()
    wcases.append({"case": f"stream16_stacked_int64_res_{2 * DECODE_B}x{BLOCKSIZE}",
                   "restore_scan_max_abs_err": err(xk, xp)})
    del xk, xp, rows16, rargs_w
    # every frame of the 32-bit stream of phase 10
    d832 = np.frombuffer(wide_streams[32], np.uint8)
    blocks32, ao32 = parse_metadata(wide_streams[32])
    offsets32 = st.index_frames(d832, ao32, blocks32[0])
    words32 = torch.as_tensor(fd.bytes_to_words(d832, bucket=True), device=dev)
    geom32 = fd.DecoderGeometry(blocksize=BLOCKSIZE, channels=2, bits_per_sample=32,
                                sample_rate=SAMPLE_RATE, max_lpc_order=DECODE_MAXORD)
    pos, assignment, _ = fd.read_frame_header(
        words32, torch.as_tensor(offsets32 * 8, device=dev), geom32.header_ext_bits, 2)
    rows32 = []
    for c in range(2):
        got, _ = wide_check(f"stream32_{len(offsets32)}x{BLOCKSIZE}_channel{c}", words32,
                            pos, fd.side_channel_bps(assignment, c, 32, 2), BLOCKSIZE)
        rows32.append((got[1], *fd.restore_inputs(got[0], DECODE_MAXORD)))
        pos = got[2]
    rargs32 = (*stack_rows(rows32), BLOCKSIZE, DECODE_MAXORD)
    xk, xp = rr.restore_scan(*rargs32), fd.restore_scan(*rargs32)
    torch.cuda.synchronize()
    wcases.append({"case": f"stream32_stacked_int64_res_{2 * len(offsets32)}x{BLOCKSIZE}",
                   "restore_scan_max_abs_err": err(xk, xp)})
    del xk, xp, rows32, rargs32
    # the guards: the fold strings (the wide scan has no fold guard), a unary
    # run of 60 zeros, and VERBATIM 32-bit samples that spend 128 bits a step
    # against a 96-bit refill
    guard_strings = dict(fold_guard_words())
    guard_strings["verbatim32_overspend"] = verbatim_words(32, 64)
    for name, w in guard_strings.items():
        wbits = 32 if name.startswith("verbatim") else 16
        T_g = 64 if name.startswith("verbatim") else 8
        got, _ = wide_check(f"guard_{name}", torch.as_tensor(w, device=dev),
                            torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.full((1,), wbits, dtype=torch.int64, device=dev), T_g)
        want_ovf = name in ("unary_60", "verbatim32_overspend")
        if bool(got[3][0]) != want_ovf:
            raise AssertionError(f"the wide scan's overflow flag is wrong on {name}")
        wcases[-1]["ovf"] = want_ovf
    # 512 random starts in random words with zero runs (phase 6's generator)
    got, _ = wide_check(f"random_{len(rstarts)}x{BLOCKSIZE}", *rargs_rnd[:3], BLOCKSIZE)
    rnd = (got[1], *fd.restore_inputs(got[0], DECODE_MAXORD), BLOCKSIZE, DECODE_MAXORD)
    xk, xp = rr.restore_scan(*rnd), fd.restore_scan(*rnd)
    torch.cuda.synchronize()
    wcases[-1]["restore_scan_max_abs_err"] = err(xk, xp)
    del got, rnd, xk, xp
    for cse in wcases:
        if any(v for k, v in cse.items() if k.endswith("max_abs_err")):
            raise AssertionError(f"the wide scan or the restore disagrees on {cse}")
    # time: the kernel on channel 0 of the 512 real frames; the plain
    # version's time is its checking call above
    wpos0, wcbps0, wide_end0, wide_plain_s = wide_timing[0]
    wide_ms = time_ms(lambda: rs.subframe_scan(words, wpos0, wcbps0, BLOCKSIZE,
                                               DECODE_MAXORD, wide=True))
    wide_plain_ms = wide_plain_s * 1e3
    # the bytes the function must move: the subframes' bits read once, res
    # (int64 in the wide scan) written once, the per-frame inputs and outputs
    wsub_bytes = int(((wide_end0 - wpos0).sum() + 7) // 8)
    wide_bytes = (wsub_bytes + DECODE_B * BLOCKSIZE * 8
                  + DECODE_B * (16 + 9 * 8 + 5 + 2 * DECODE_MAXORD * 8 + 9))
    wide_bound_ms = wide_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernels_wide", "card": card, "cases": wcases,
          "timing_shape": {"B": DECODE_B, "T": BLOCKSIZE, "maxord": DECODE_MAXORD},
          "wide_scan": {"kernel_ms": wide_ms, "plain_ms": wide_plain_ms,
                        "bound_ms": wide_bound_ms, "bytes": wide_bytes,
                        "subframe_bytes": wsub_bytes}})

    # --- 12. kernels_compact: the compaction kernel against its plain version --
    ccases = []
    compact_timing = {}
    enc5 = build_frame_encoder(cfg, device=dev)
    enc8 = build_frame_encoder(cfg8, device=dev)
    real_batches = [(f"level5_batch_64x{BLOCKSIZE}", *enc5(frames[:64], np.arange(64))[:2]),
                    (f"level8_24bit_batch_64x{BLOCKSIZE}",
                     *enc8(frames24[:64], np.arange(64))[:2]),
                    (f"level5_batch_{DECODE_B}x{BLOCKSIZE}",
                     *enc5(frames[:DECODE_B], np.arange(DECODE_B))[:2])]
    for name, w_c, tb_c in compaction_cases() + real_batches:
        w_c = torch.as_tensor(w_c, device=dev)
        tb_c = torch.as_tensor(tb_c, device=dev)
        got = cst.compact_stream(w_c, tb_c)
        ref = packer.compact_stream_words(w_c, tb_c)
        torch.cuda.synchronize()
        cerr = max(err(got[0], ref[0]), abs(int(got[1]) - int(ref[1])))
        ccases.append({"case": name, "shape": list(w_c.shape), "bytes": int(ref[1]),
                       "max_abs_err": cerr})
        if cerr:
            raise AssertionError(f"the compaction kernel disagrees on {name}: {cerr}")
        if name.startswith("level"):
            nb, wn = w_c.shape
            nbytes_c = (tb_c.to(torch.int64) + 7) // 8
            # the library yardstick, which the port never calls: one
            # masked_select of the frames' byte rows gives the stream's bytes
            rows = packer.big_endian_bytes(w_c)
            keep = torch.arange(4 * wn, device=dev)[None, :] < nbytes_c[:, None]
            lib_bytes = torch.masked_select(rows, keep)
            stream_bytes = packer.compact_stream_bytes(w_c, tb_c)[0][: int(got[1])]
            if not torch.equal(lib_bytes, stream_bytes):
                raise AssertionError(f"masked_select disagrees with the kernel on {name}")
            # the valid words read once, total_bits read once, the B*W words
            # and the total written once
            read_words = int(((nbytes_c + 3) // 4).sum())
            c_bytes = read_words * 4 + nb * 4 + nb * wn * 4 + 8
            compact_timing[name] = {
                "kernel_ms": graph_ms(lambda: cst.compact_stream(w_c, tb_c)),
                "plain_ms": time_ms(lambda: packer.compact_stream_words(w_c, tb_c),
                                    iters=3, warmup=1),
                # masked_select sizes its output from the data, which
                # synchronises: CUDA events around back-to-back calls
                "library_ms": time_ms(lambda: torch.masked_select(rows, keep)),
                "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bytes": c_bytes, "stream_bytes": int(got[1]),
                "padded_bytes": nb * wn * 4}
            del rows, keep, lib_bytes, stream_bytes
    del real_batches, enc5, enc8
    torch.cuda.empty_cache()
    emit({"phase": "kernels_compact", "card": card, "kernel": "compact_stream_kernel",
          "cases": ccases, "timing": compact_timing})

    # --- 13. decode_variable: a variable-blocksize stream on the card ----------
    # segments of the 60 s PCM at three blocksizes, interleaved, plus three
    # frames of 1000 samples, which go to the host decoder (_VAR_MIN_GROUP)
    var_segments = [(4096, 100), (2304, 200), (1152, 390), (1000, 1),
                    (4096, 100), (2304, 200), (1152, 390), (1000, 2)]
    with tempfile.TemporaryDirectory() as tmp:
        def encode_segment(seg, bs):
            path = os.path.join(tmp, "seg.flac")
            encode_file(seg, SAMPLE_RATE, 16, path, level=5, blocksize=bs)
            with open(path, "rb") as f:
                return f.read()

        t0 = time.perf_counter()
        data_var = variable_blocksize_stream(pcm, var_segments, SAMPLE_RATE, 16,
                                             encode_segment)
        var_make_s = time.perf_counter() - t0
    n_var = sum(bs * k for bs, k in var_segments)
    groups = {}
    for bs, k in var_segments:
        groups[bs] = groups.get(bs, 0) + k
    var_batches = sum(-(-k // 64) for bs, k in groups.items() if k >= 4)
    var_host = sum(k for k in groups.values() if k < 4)
    torch.cuda.synchronize()
    rs.launches = rs.wide_launches = rr.launches = 0
    t0 = time.perf_counter()
    vout, vsi, vinfo = st.decode_bytes_device(data_var)
    torch.cuda.synchronize()
    var_wall = time.perf_counter() - t0
    var_launches = (rs.launches, rs.wide_launches, rr.launches)
    if vsi.min_blocksize == vsi.max_blocksize or vsi.md5sum == b"\x00" * 16:
        raise AssertionError("the variable-blocksize stream's STREAMINFO is wrong")
    if not np.array_equal(vout, pcm[:n_var]):
        raise AssertionError("the variable-blocksize decode did not return the input")
    if vinfo["path"] != "device-variable" or vinfo["errors"] \
            or vinfo["frames"] != sum(groups.values()):
        raise AssertionError(f"variable-blocksize decode: {vinfo}")
    if vinfo["host_frames"] != var_host + vinfo["overflow_frames"]:
        raise AssertionError(f"variable-blocksize frames on the host: {vinfo}")
    if var_launches != (2 * var_batches, 0, var_batches):
        raise AssertionError(f"the variable decode launched (scan, wide scan, restore) "
                             f"{var_launches} for {var_batches} group batches")
    vblocks = list(st.StreamDecoder(data_var).iter_blocks())
    if not np.array_equal(np.concatenate(vblocks), vout):
        raise AssertionError("iter_blocks differs from decode_all on the variable stream")
    var_walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.decode_bytes_device(data_var)
        torch.cuda.synchronize()
        var_walls.append(time.perf_counter() - t0)
    emit({"phase": "decode_variable", "card": card, "segments": var_segments,
          "groups": groups, "samples_per_channel": n_var, "bytes": len(data_var),
          "make_s": var_make_s, "frames": vinfo["frames"], "path": vinfo["path"],
          "host_frames": vinfo["host_frames"], "overflow_frames": vinfo["overflow_frames"],
          "group_batches": var_batches, "subframe_scan_launches": var_launches[0],
          "restore_scan_launches": var_launches[2], "lossless": True, "md5_checked": True,
          "iter_blocks_equal": True, "wall_s": var_wall, "wall_s_repeats": var_walls,
          "wall_s_median_of_repeats": float(np.median(var_walls)),
          "msamples_per_s_per_channel": n_var / float(np.median(var_walls)) / 1e6})
    del data_var, vout, vblocks

    # --- 14. seek_stream: positioned and bounded-memory decodes on the card ----
    seek_cases = []
    sdec = sk.SeekableDecoder(data)
    # from 0; from mid-frame; across a 64-frame batch of the device read; the
    # final partial frame
    for s0, cnt in ((0, 20 * BLOCKSIZE), (5 * BLOCKSIZE + 1234, 9 * BLOCKSIZE),
                    (100 * BLOCKSIZE + 77, 70 * BLOCKSIZE), (n - 1000, 1000)):
        torch.cuda.synchronize()
        rs.launches = rr.launches = 0
        t0 = time.perf_counter()
        got = sdec.decode_range(s0, cnt)
        seek_s = time.perf_counter() - t0
        if not np.array_equal(got, pcm[s0:s0 + cnt]):
            raise AssertionError(f"decode_range({s0}, {cnt}) differs from the input")
        seek_cases.append({"start": s0, "samples": cnt, "seconds": seek_s,
                           "subframe_scan_launches": rs.launches,
                           "restore_scan_launches": rr.launches})
    if sum(c["restore_scan_launches"] for c in seek_cases) == 0:
        raise AssertionError("no seek read went through the device decoder")
    torch.cuda.synchronize()
    rs.launches = rr.launches = 0
    t0 = time.perf_counter()
    cdec = sm.ChunkedStreamDecoder(io.BytesIO(data), window_bytes=1 << 20)
    cblocks = list(cdec.iter_blocks())  # MD5 checked at exhaustion
    chunked_s = time.perf_counter() - t0
    if not np.array_equal(np.concatenate(cblocks), pcm):
        raise AssertionError("ChunkedStreamDecoder did not return the input")
    chunked = {"window_bytes": cdec.window, "stream_bytes": len(data),
               "blocks": len(cblocks), "seconds": chunked_s,
               "subframe_scan_launches": rs.launches, "restore_scan_launches": rr.launches,
               "info": cdec.decode_info}
    if len(data) <= cdec.window or rr.launches == 0:
        raise AssertionError(f"the chunked decode took one window or no device batch: "
                             f"{chunked}")
    del cblocks
    # lpc_restore through the restore kernel, against its plain version, on
    # the LPC subframes of the 60 s stream's first 512 frames
    pos, assignment, _ = fd.read_frame_header(words, starts, geom.header_ext_bits, 2)
    lpc_rows = []
    for c in range(2):
        sub, res_c, pos, _ = rs.subframe_scan(
            words, pos, fd.side_channel_bps(assignment, c, 16, 2), BLOCKSIZE, DECODE_MAXORD)
        m = sub["is_lpc"]
        lpc_rows.append((res_c[m], sub["qlp"][m], sub["order"][m],
                         torch.clamp(sub["shift"][m], min=0), sub["warm"][m]))
    largs = (*stack_rows(lpc_rows), DECODE_MAXORD)
    torch.cuda.synchronize()
    rr.launches = 0
    xk = lpc.lpc_restore(*largs)
    lpc_launches = rr.launches
    xp = lpc.lpc_restore_plain(*largs)
    torch.cuda.synchronize()
    lpc_err = err(xk, xp)
    if lpc_err or lpc_launches != 1:
        raise AssertionError(f"lpc_restore on the card: error {lpc_err}, "
                             f"{lpc_launches} restore launches")
    lpc_ms = time_ms(lambda: lpc.lpc_restore(*largs))
    lpc_plain_ms = time_ms(lambda: lpc.lpc_restore_plain(*largs), iters=2, warmup=0)
    # as the restore's bound: res read, x written, coefficients and warmup
    # read once; (T - order) * order multiply-adds a row
    lpc_rows_n, lpc_order = int(largs[0].shape[0]), largs[2].clamp(0, DECODE_MAXORD)
    lpc_bytes_ms = (lpc_rows_n * BLOCKSIZE * (4 + 8) + lpc_rows_n * DECODE_MAXORD * 16
                    + lpc_rows_n * 17) / HBM_BYTES_PER_S * 1e3
    lpc_ops_ms = int(((BLOCKSIZE - lpc_order) * lpc_order).sum()) / INT32_MACS_PER_S * 1e3
    emit({"phase": "seek_stream", "card": card, "decode_range": seek_cases,
          "chunked": chunked, "lpc_restore": {"rows": lpc_rows_n, "max_abs_err": lpc_err,
                                              "restore_scan_launches": lpc_launches,
                                              "kernel_ms": lpc_ms, "plain_ms": lpc_plain_ms,
                                              "bound_ms": max(lpc_bytes_ms, lpc_ops_ms),
                                              "bound_by": "bytes" if lpc_bytes_ms >= lpc_ops_ms
                                              else "operations"}})
    del lpc_rows, largs, xk, xp

    # --- 15. replaygain: the equal-loudness kernel, an album, metaflac --------
    def rg_plain(x, fi):
        return rg.iir_filter(rg.A_BUTTER[fi], rg.B_BUTTER[fi],
                             rg.iir_filter(rg.A_YULE[fi], rg.B_YULE[fi], x))

    def rg_exact(x, fi, m):
        """fma_reference's cascade over each channel's first m samples."""
        xe = x[:, :m].cpu().numpy()
        return np.stack([rg.fma_reference(rg.A_BUTTER[fi], rg.B_BUTTER[fi], rg.fma_reference(
            rg.A_YULE[fi], rg.B_YULE[fi], xe[c])) for c in range(xe.shape[0])])

    def ragged_launch(xs, fi, exact_n):
        """One launch over the titles xs: its launch count, and for each
        title whether it equals its own one-title launch over its whole
        length and fma_reference on its first exact_n samples."""
        iir.launches = 0
        ys = rg.equal_loudness_album(xs, fi)
        torch.cuda.synchronize()
        n_launches, taps = iir.launches, rg.equalizer_taps(fi)
        rows = []
        for x, y in zip(xs, ys):
            m = min(exact_n, int(x.shape[1]))
            rows.append({"samples_per_channel": int(x.shape[1]),
                         "equals_one_title_launch": bool(torch.equal(
                             y, iir.equal_loudness(x, taps))),
                         "equals_fma_reference": bool(np.array_equal(
                             y[:, :m].cpu().numpy(), rg_exact(x, fi, m)))})
        return n_launches, rows

    def rg_check(name, sig, rate, bps):
        """The kernel against the plain version on the card, on the scaled
        input GainAnalysis gives them: the error of the whole output, bit
        equality with fma_reference on the first RG_EXACT samples, and equal
        title gains from the two routes."""
        fi = rg.SAMPLE_RATES.index(rate)
        gk, gp = rg.GainAnalysis(rate), rg.GainAnalysis(rate)
        x = gk.scaled_input(sig, bps)
        iir.launches = 0
        yk = rg.equal_loudness(x, fi)
        yp = rg_plain(x, fi)
        torch.cuda.synchronize()
        if iir.launches != 1:
            raise AssertionError(f"{name}: {iir.launches} kernel launches for one call")
        peak = float(yp.abs().max())
        abs_err = float((yk - yp).abs().max())
        exact_equal = bool(np.array_equal(yk[:, :RG_EXACT].cpu().numpy(),
                                          rg_exact(x, fi, RG_EXACT)))
        out_k, out_p = yk.cpu().numpy(), yp.cpu().numpy()
        gk.add_windows(out_k)
        gp.add_windows(out_p)
        case = {"case": name, "sample_rate": rate, "bits_per_sample": bps,
                "samples_per_channel": int(x.shape[1]), "peak": peak, "max_abs_err": abs_err,
                "max_rel_err": abs_err / peak, "share_exactly_equal":
                float((out_k == out_p).mean()), "equals_fma_reference": exact_equal,
                "title_gain_kernel": gk.title_gain(), "title_gain_plain": gp.title_gain()}
        if not abs_err <= RG_REL_TOL * peak or not exact_equal \
                or case["title_gain_kernel"] != case["title_gain_plain"]:
            raise AssertionError(f"the equal-loudness kernel against its plain version: {case}")
        return case, x

    def rate_excerpt(rate, seed, level):
        sig = make_pcm(int(rate * RG_EXCERPT_S), seed=seed, rate=rate)
        return np.round(sig * level).astype(np.int32)

    rg_cases = [rg_check("44100_loud", pcm[: int(SAMPLE_RATE * RG_EXCERPT_S)], SAMPLE_RATE,
                         16)[0],
                rg_check("96000_24bit", pcm24[: int(HIRES_RATE * RG_EXCERPT_S)], HIRES_RATE,
                         24)[0],
                rg_check("8000_near_silent", rate_excerpt(8000, 81, 2e-4), 8000, 16)[0],
                rg_check("44100_near_silent", rate_excerpt(SAMPLE_RATE, 82, 1e-4),
                         SAMPLE_RATE, 16)[0]]
    # one ragged launch over titles of unequal length (the 96 kHz taps for
    # all), and one of 2 x RG_MANY_TITLES blocks, so that blocks share SMs
    ga96 = rg.GainAnalysis(HIRES_RATE)
    rag_x = [ga96.scaled_input(make_pcm(n, seed=90 + k, rate=HIRES_RATE), 16)
             for k, n in enumerate(RG_RAGGED)]
    rag_x.append(ga96.scaled_input(pcm24[: int(HIRES_RATE * RG_EXCERPT_S)], 24))
    rag_launches, ragged = ragged_launch(rag_x, rg.SAMPLE_RATES.index(HIRES_RATE), RG_EXACT)
    if rag_launches != 1 or not all(r["equals_one_title_launch"] and r["equals_fma_reference"]
                                    for r in ragged):
        raise AssertionError(f"the ragged launch ({rag_launches} launches): {ragged}")
    many_rng = np.random.default_rng(91)
    many_x = [torch.from_numpy(many_rng.normal(0, 5000.0, (2, int(n)))).to(dev)
              for n in many_rng.integers(1, RG_MANY_MAX + 1, size=RG_MANY_TITLES)]
    many_launches, many_rows = ragged_launch(many_x, rg.SAMPLE_RATES.index(SAMPLE_RATE),
                                             RG_MANY_EXACT)
    many = {"titles": RG_MANY_TITLES, "segments": 2 * RG_MANY_TITLES, "launches": many_launches,
            "samples_per_channel": [r["samples_per_channel"] for r in many_rows],
            "all_equal_one_title_launch": all(r["equals_one_title_launch"] for r in many_rows),
            "all_equal_fma_reference": all(r["equals_fma_reference"] for r in many_rows)}
    bad = [r for r in many_rows
           if not (r["equals_one_title_launch"] and r["equals_fma_reference"])]
    if many_launches != 1 or bad:
        raise AssertionError(f"the launch of {2 * RG_MANY_TITLES} blocks ({many_launches} "
                             f"launches): {bad}")
    del rag_x, many_x
    lat = {}
    for op in ("fma", "add"):
        lat[op] = (iir.fp64_latency_probe(1 << 22, op) - iir.fp64_latency_probe(1 << 21, op)
                   ) / (1 << 21) * 1e6  # ns
    # the loop-carried path a sample: 2 dependent FMAs and 4 additions
    ns_per_sample_bound = 2 * lat["fma"] + 4 * lat["add"]

    # the album: encode on the card, tag through add_replay_gain_tags
    album_dir = tempfile.TemporaryDirectory()
    paths, titles_pcm, encoded, album_make_s, album_encode_s = [], [], [], 0.0, 0.0
    for k, (minutes, level) in enumerate(zip(ALBUM_MINUTES, ALBUM_LOUDNESS)):
        t0 = time.perf_counter()
        tp = np.round(make_pcm(int(minutes * 60 * SAMPLE_RATE), seed=70 + k) * level
                      ).astype(np.int32)
        album_make_s += time.perf_counter() - t0
        path_k = os.path.join(album_dir.name, f"title{k}.flac")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_file(tp, SAMPLE_RATE, 16, path_k, level=5, metadata=[Padding(length=8192)])
        torch.cuda.synchronize()
        album_encode_s += time.perf_counter() - t0
        paths.append(path_k)
        titles_pcm.append(tp)
        with open(path_k, "rb") as f:
            encoded.append(f.read())
    torch.cuda.synchronize()
    iir.launches = 0
    t0 = time.perf_counter()
    rg.add_replay_gain_tags(paths)
    torch.cuda.synchronize()
    album_wall = time.perf_counter() - t0
    album_launches = iir.launches
    if album_launches != 1:
        raise AssertionError(f"the album launched the kernel {album_launches} times for "
                             f"{len(paths)} titles, not once")

    def check_tags(path_k, before):
        """The five tags in flac_tpu's formats, the audio bytes untouched;
        returns (title gain, title peak, album gain, album peak) as read."""
        with open(path_k, "rb") as f:
            after = f.read()
        if after[parse_metadata(after)[1]:] != before[parse_metadata(before)[1]:]:
            raise AssertionError(f"tagging changed the audio bytes of {path_k}")
        vc = get_tags(path_k)
        tags = {t: vc.find_entry(t) for t in (rg.TAG_REFERENCE_LOUDNESS, rg.TAG_TITLE_GAIN,
                                              rg.TAG_TITLE_PEAK, rg.TAG_ALBUM_GAIN,
                                              rg.TAG_ALBUM_PEAK)}
        formats = {rg.TAG_REFERENCE_LOUDNESS: r"89\.0 dB", rg.TAG_TITLE_GAIN: r"[+-]\d+\.\d\d dB",
                   rg.TAG_ALBUM_GAIN: r"[+-]\d+\.\d\d dB", rg.TAG_TITLE_PEAK: r"\d\.\d{8}",
                   rg.TAG_ALBUM_PEAK: r"\d\.\d{8}"}
        for tag, pattern in formats.items():
            if tags[tag] is None or not re.fullmatch(pattern, tags[tag]):
                raise AssertionError(f"{path_k}: {tag}={tags[tag]!r}")
        if len(vc.comments) != len(set(c.split("=")[0] for c in vc.comments)):
            raise AssertionError(f"{path_k}: a tag is written twice: {vc.comments}")
        return (float(tags[rg.TAG_TITLE_GAIN].split()[0]), float(tags[rg.TAG_TITLE_PEAK]),
                float(tags[rg.TAG_ALBUM_GAIN].split()[0]), float(tags[rg.TAG_ALBUM_PEAK]))

    album_tags = [check_tags(p, e) for p, e in zip(paths, encoded)]
    if len({t[2:] for t in album_tags}) != 1:
        raise AssertionError(f"the titles carry different album tags: {album_tags}")
    if [t[0] for t in album_tags] != sorted(t[0] for t in album_tags) \
            or len({t[0] for t in album_tags}) != len(album_tags):
        raise AssertionError(f"the title gains do not rise as the loudness falls: {album_tags}")
    # every file still decodes on the card to its input, MD5 checked
    for p, tp in zip(paths, titles_pcm):
        with open(p, "rb") as f:
            if not np.array_equal(st.decode_bytes_device(f.read())[0], tp):
                raise AssertionError(f"{p} does not decode to its input after tagging")
    # the album again, by stage: the same steps as compute_replay_gain
    ga = None
    stages, xs = [], []
    for k, p in enumerate(paths):
        with open(p, "rb") as f:
            data_k = f.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pcm_k, si_k, _ = st.decode_bytes_device(data_k, check_md5=False)
        decode_s = time.perf_counter() - t0
        if ga is None:
            ga = rg.GainAnalysis(si_k.sample_rate)
        t0 = time.perf_counter()
        x = ga.scaled_input(pcm_k, si_k.bits_per_sample)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        stages.append({"title": k, "minutes": ALBUM_MINUTES[k], "loudness": ALBUM_LOUDNESS[k],
                       "samples_per_channel": int(x.shape[1]), "title_peak": ga.title_peak,
                       "decode_s": decode_s, "upload_s": upload_s})
        ga.title_peak = 0.0
        xs.append(x)
    # the album's filter as compute_replay_gain runs it: the layout's copies
    # and one launch, by CUDA events; each title held against the plain
    # version on the card
    if sum(rg.launch_bytes(x) for x in xs) > rg.LAUNCH_BYTES:
        raise AssertionError("the album does not fit one launch")
    fi0 = ga.freq_index
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    iir.launches = 0
    torch.cuda.synchronize()
    ev0.record()
    ys = rg.equal_loudness_album(xs, fi0)
    ev1.record()
    torch.cuda.synchronize()
    album_kernel_ms = ev0.elapsed_time(ev1)
    if iir.launches != 1:
        raise AssertionError(f"equal_loudness_album launched {iir.launches} times, not once")
    for k, y in enumerate(ys):
        t0 = time.perf_counter()
        out = y.cpu().numpy()
        copy_back_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ga.add_windows(out)
        gain_k = ga.title_gain()
        host_stats_s = time.perf_counter() - t0
        if f"{gain_k:+2.2f}" != f"{album_tags[k][0]:+2.2f}":
            raise AssertionError(f"title {k}: gain {gain_k} by stage, {album_tags[k][0]} tagged")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yp = rg_plain(xs[k], fi0)
        torch.cuda.synchronize()
        plain_ms_k = (time.perf_counter() - t0) * 1e3
        peak_k = float(yp.abs().max())
        err_k = float((y - yp).abs().max())
        stages[k].update({"title_gain": gain_k, "copy_back_s": copy_back_s,
                          "host_stats_s": host_stats_s, "plain_ms": plain_ms_k,
                          "max_abs_err": err_k, "max_rel_err": err_k / peak_k})
        if not err_k <= RG_REL_TOL * peak_k:
            raise AssertionError(f"title {k} of the album's launch against the plain version: "
                                 f"{err_k} of a {peak_k} peak")
        del out, yp
    if f"{ga.album_gain():+2.2f}" != f"{album_tags[0][2]:+2.2f}":
        raise AssertionError(f"album gain {ga.album_gain()} by stage, {album_tags[0][2]} tagged")
    n_long = max(s_["samples_per_channel"] for s_ in stages)
    album_kernel = {"kernel_ms": album_kernel_ms,
                    "longest_samples_per_channel": n_long,
                    "kernel_ns_per_sample_longest": album_kernel_ms * 1e6 / n_long,
                    "latency_bound_ms_longest": n_long * ns_per_sample_bound * 1e-6,
                    "max_abs_err": max(s_["max_abs_err"] for s_ in stages),
                    "max_rel_err": max(s_["max_rel_err"] for s_ in stages)}
    # the kernel at the main path's shape: the first title alone, bit-equal
    # to its segment of the album's launch
    x0 = xs[0]
    iir_ms = time_ms(lambda: rg.equal_loudness(x0, fi0), iters=3, warmup=1)
    yk0 = rg.equal_loudness(x0, fi0)
    if not torch.equal(yk0, ys[0]):
        raise AssertionError("title 0 alone differs from its segment of the album's launch")
    iir_plain_ms, title_err = stages[0]["plain_ms"], stages[0]["max_abs_err"]
    n0 = int(x0.shape[1])
    iir_bytes_ms = 2 * 2 * n0 * 8 / HBM_BYTES_PER_S * 1e3
    iir_ops_ms = 2 * n0 * RG_FLOPS_PER_SAMPLE / FP64_FLOPS_PER_S * 1e3
    iir_timing = {"samples_per_channel": n0, "kernel_ms": iir_ms,
                  "kernel_ns_per_sample": iir_ms * 1e6 / n0, "plain_ms": iir_plain_ms,
                  "max_abs_err": title_err, "max_rel_err": stages[0]["max_rel_err"],
                  "equals_album_launch": True,
                  "bytes_ms": iir_bytes_ms, "ops_ms": iir_ops_ms,
                  "latency_bound_ms": n0 * ns_per_sample_bound * 1e-6}
    del xs, ys, x0, yk0
    # the album again through compute_replay_gain under a lowered
    # LAUNCH_BYTES: titles 0 and 1 in one launch, 2 and 3 alone, with the
    # one launch's gains and peaks
    cap = rg.LAUNCH_BYTES
    rg.LAUNCH_BYTES = 2 * 2 * 8 * (iir.padded(stages[0]["samples_per_channel"])
                                   + iir.padded(stages[1]["samples_per_channel"]))
    try:
        iir.launches = 0
        grouped = rg.compute_replay_gain(paths)
        torch.cuda.synchronize()
        grouped_launches = iir.launches
    finally:
        rg.LAUNCH_BYTES = cap
    want = (ga.album_gain(), max(s_["title_peak"] for s_ in stages),
            [(s_["title_gain"], s_["title_peak"]) for s_ in stages])
    if grouped_launches != 3 or grouped != want:
        raise AssertionError(f"compute_replay_gain in groups: {grouped_launches} launches, "
                             f"{grouped} against {want}")
    del titles_pcm, encoded
    album_dir.cleanup()
    # metaflac --add-replay-gain on the 30 s 24-bit/96 kHz stream, on the
    # card by the device rule (FLAC_TPU_DEVICE unset)
    os.environ.pop("FLAC_TPU_DEVICE", None)
    with tempfile.TemporaryDirectory() as tmp:
        hp = os.path.join(tmp, "hires.flac")
        with open(hp, "wb") as f:
            f.write(data24)
        torch.cuda.synchronize()
        iir.launches = 0
        t0 = time.perf_counter()
        cli_rc = metaflac.main(["--add-replay-gain", hp])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = iir.launches
        hires_tags = check_tags(hp, data24)
        with open(hp, "rb") as f:
            if not np.array_equal(st.decode_bytes_device(f.read())[0], pcm24):
                raise AssertionError("the tagged 24-bit stream does not decode to its input")
    if cli_rc != 0 or cli_launches != 1:
        raise AssertionError(f"metaflac --add-replay-gain: rc {cli_rc}, {cli_launches} "
                             f"kernel launches")
    emit({"phase": "replaygain", "card": card, "cases": rg_cases,
          "ragged": {"launches": rag_launches, "segments": ragged}, "many_blocks": many,
          "fp64_latency_ns": lat, "latency_bound_ns_per_sample": ns_per_sample_bound,
          "album": {"titles": len(paths), "minutes": list(ALBUM_MINUTES),
                    "loudness": list(ALBUM_LOUDNESS), "make_s": album_make_s,
                    "encode_s": album_encode_s, "wall_s": album_wall,
                    "kernel_launches": album_launches, "tags": album_tags,
                    "album_gain": ga.album_gain(), "stages": stages,
                    "kernel": album_kernel, "grouped_launches": grouped_launches},
          "title0": iir_timing,
          "metaflac_hires": {"rc": cli_rc, "seconds": cli_s, "kernel_launches": cli_launches,
                             "tags": hires_tags}})

    # --- 16. kernels line ---------------------------------------------------
    def pack_row(name, merged, replaces, main_launches):
        row = pack_rows[merged]
        t512, t64 = row["timing"]["B512"], row["timing"]["B64"]
        return {"name": name, "route": "cuda", "kernel": f"pack_frames_kernel<{str(merged).lower()}, true>",
                "source": "flac_tpu_torch/csrc/pack_words.cu", "replaces": replaces,
                "launches": main_launches,
                "bit_exact": all(c["max_abs_err"] == 0 for c in row["cases"]),
                "max_abs_err": max(c["max_abs_err"] for c in row["cases"]),
                "ms": t512["kernel_ms"], "plain_ms": t512["plain_ms"],
                "bound_ms": t512["bound_ms"], "bound_by": t512["bound_by"],
                "library_ms": t512["library_ms"], "ms_b64": t64["kernel_ms"],
                "bound_ms_b64": t64["bound_ms"], "fill_only_ms": t512["fill_only_ms"]}

    ct512 = compact_timing[f"level5_batch_{DECODE_B}x{BLOCKSIZE}"]
    emit({"kernels": [
        pack_row("pack_words", False, "flac_tpu/encode/packer.py:443", launches),
        pack_row("pack_words_multi", True, "flac_tpu/encode/packer.py:678",
                 merged_launches), {
        "name": "residual_scan", "route": "cuda", "kernel": "subframe_scan",
        "source": "flac_tpu_torch/csrc/residual_scan.cu",
        "replaces": "flac_tpu/decode/frame_decoder.py:409-456, :291",
        "launches": decode_launches[0], "bit_exact": True,
        "max_abs_err": max(c.get("subframe_scan_max_abs_err", 0) for c in dcases),
        "ms": scan_ms, "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "restore_scan", "route": "cuda",
        "source": "flac_tpu_torch/csrc/restore_scan.cu",
        "replaces": "flac_tpu/decode/frame_decoder.py:628",
        "launches": decode_launches[1] + lpc_launches,
        "launches_decode": decode_launches[1], "launches_lpc_restore": lpc_launches,
        "bit_exact": True,
        "max_abs_err": max([c.get("restore_scan_max_abs_err", 0) for c in dcases + wcases]
                           + [lpc_err]),
        "ms": restore_ms, "plain_ms": restore_plain_ms, "bound_ms": restore_bound_ms,
        "bound_by": "bytes" if restore_bytes_ms >= restore_ops_ms else "operations",
        "library_ms": None}, {
        "name": "residual_scan_wide", "route": "cuda", "kernel": "subframe_scan<wide>",
        "source": "flac_tpu_torch/csrc/residual_scan.cu",
        "replaces": "flac_tpu/decode/frame_decoder.py:484-595, :590",
        "launches": wide_decode_launches, "bit_exact": True,
        "max_abs_err": max(c.get("subframe_scan_max_abs_err", 0) for c in wcases),
        "ms": wide_ms, "plain_ms": wide_plain_ms, "bound_ms": wide_bound_ms,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "compact_stream", "route": "cuda", "kernel": "compact_stream_kernel",
        "source": "flac_tpu_torch/csrc/compact_stream.cu",
        "replaces": "flac_tpu/encode/packer.py:181",
        "launches": compact_launches, "bit_exact": True,
        "max_abs_err": max(c["max_abs_err"] for c in ccases),
        "ms": ct512["kernel_ms"], "plain_ms": ct512["plain_ms"],
        "bound_ms": ct512["bound_ms"], "bound_by": "bytes",
        "library_ms": ct512["library_ms"],
        "ms_b64": compact_timing[f"level5_batch_64x{BLOCKSIZE}"]["kernel_ms"]}, {
        "name": "iir_scan", "route": "cuda", "kernel": "equal_loudness_kernel",
        "source": "flac_tpu_torch/csrc/iir_scan.cu",
        "replaces": "flac_tpu/replaygain/__init__.py:73",
        "launches": album_launches, "launches_metaflac": cli_launches,
        "equals_fma_reference": all(c["equals_fma_reference"] for c in rg_cases)
        and all(r["equals_fma_reference"] for r in ragged) and many["all_equal_fma_reference"],
        "max_abs_err": max([c["max_abs_err"] for c in rg_cases]
                           + [album_kernel["max_abs_err"]]),
        "max_rel_err": max([c["max_rel_err"] for c in rg_cases]
                           + [album_kernel["max_rel_err"]]),
        "ms": iir_ms, "plain_ms": iir_plain_ms,
        "bound_ms": max(iir_bytes_ms, iir_ops_ms),
        "bound_by": "bytes" if iir_bytes_ms >= iir_ops_ms else "operations",
        "latency_bound_ms": iir_timing["latency_bound_ms"],
        "library_ms": None, "samples_per_channel": n0,
        "album_ms": album_kernel_ms}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
