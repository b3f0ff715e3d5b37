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
                    the stream encoder's one route (each batch of full frames
                    compacted on the card, its valid words copied back and
                    written in one piece); the pack kernel's launch count
                    must equal the number of frame batches (the final
                    partial block included), the compaction kernel's the
                    number of batches of full frames (the partial frame
                    comes back as its own word row), and the stream's
                    SHA-256 the recorded one. The file is
                    decoded by the port's host decoder (CRC-8, CRC-16 and MD5
                    checked) and must give the PCM back. The first batch is
                    also encoded on the CPU, and must give the same bytes
                    frame for frame. One 64-frame batch
                    is timed by stage on the host clock (the two device
                    stages; the host's MD5, the step, its copy back and
                    emit) and the step once under
                    torch.profiler (device busy time, device events); the idle
                    share divides the busy time by the unprofiled wall; 3
                    pack() calls under the profiler (after a warm-up step)
                    must be 3 pack kernels and no other device event. These
                    stages are the eager ones (the steps' `.fn`). On CUDA
                    the encode step is one CUDA graph a batch shape
                    (flac_tpu_torch/graphs.py): the encode must run its
                    first batch eagerly, capture at the second and replay
                    the rest (one capture and full batches - 2 replays; the
                    partial frame's step once, eagerly), every launch count
                    still one a call. graph_step_check runs three batches
                    through fresh graphed steps (eager, capture, replay),
                    each equal to build_frame_encoder_parts and the
                    compaction on the card, and times the replayed batch
                    (host and wall, device busy time and events), the
                    capture, and the pool at B=64 and B=512, and reads the
                    dense step's graph (its programmatic edge). The whole
                    encode runs once more (all replays), then under
                    torch.profiler (device only); its busy time over the
                    first run's wall and over the replayed run's gives the
                    run's idle shares. The stream's SHA-256 is printed, to
                    compare streams across versions.
5. encode_merged  — encode_file(level=5, verify=True) of the same 60 s: its
                    bytes must equal phase 4's, every step call replays a
                    graph phase 4 captured, pack must launch once a batch,
                    the compaction once a batch of full frames, and the
                    verifier must decode every batch of full frames through
                    the decode kernels (the subframe scan once a channel, the
                    restore once) without a VerifyError; verify decodes
                    flac_tpu's byte rows (each frame in a row of the batch's
                    largest frame length). Then the merged fill, which the
                    encoder does not take: the fields of every batch of the
                    stream (build_frame_encoder_parts; the final partial
                    frame at its length) packed by
                    pack_frames_kernel(merged=True) must give the banded
                    fill's words and bit counts, each fill launched once a
                    batch (phase 3 times the two fills against each other).
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
                    device idle share taken as in phase 4, and the graphed
                    steps checked and timed as in phase 4; the graph route
                    as in phase 4; the SHA-256 must be the recorded one.
                    Then 10 s of the same format with -p and escape coding
                    on tests/test_escape.py's burst signal: escaped
                    partitions, lossless, the first 8 frames CPU-identical,
                    the graph route as in phase 4, its SHA-256 printed.
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
                    once a batch of full frames, the one batch eager (no
                    capture); lossless on the
                    host decoder; then decode_bytes_device of each gives the
                    exact input through the wide scan kernel, launches
                    counted.
11. kernels_wide   — holds the wide scan kernel against wide_residual_scan's
                    composition bit for bit on every output (every parse
                    field, int64 res, end positions, overflow flags), with
                    the count of frames each launch sent to its exact path:
                    the first 512 frames of phase 4's stream read wide, every
                    frame of phase 10's 32-bit stream, the guard strings
                    (the fold strings, which the wide scan has no guard for;
                    a unary run of 60 zeros; VERBATIM 32-bit samples that
                    outrun the refill), phase 6's 512 random starts, and one
                    B=512 launch that mixes the 16-bit frames with the guard
                    strings and wasted-run starts (both paths in one
                    launch); the restore's int64-res instantiation on the
                    same rows. Times the kernel, its exact path over all 512
                    frames and the narrow kernel on the same frames in
                    turns (CUDA-graph replay), the kernel on the 32-bit
                    stream and the plain version at B=512, T=4096, with the
                    bytes bound and the walk's latency floor (T dependent
                    walk steps, one step's latency by a one-thread probe).
12. kernels_compact — holds the compaction kernel against compact_stream_words,
                    bit for bit on every word and the total, on the four
                    cases of tests/test_dense_path.py::TestCompaction
                    (regenerated from seed 123), the edge cases of its
                    output-driven grid (compaction_edge_cases, the silent
                    frames encoded here) and the packed words of
                    a level-5 B=64 batch, a 24-bit -8 B=64 batch and a
                    level-5 B=512 batch; times the kernel (CUDA-graph
                    replay), the plain version and one torch.masked_select
                    of the byte rows (the library yardstick, which the port
                    never calls; CUDA events, since it synchronises) on the
                    three real batches, with the bytes bound; the launch
                    floor (the source's empty kernel on the B=64 grid, with
                    and without programmatic dependent launch) and the
                    compaction's cost after pack() at B=64 (a graph of pack
                    then compaction, less one of pack alone; the empty
                    kernel after pack() the same way).
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
17. cli            — the `flac` command in process
                    (flac_tpu_torch.cli.flac.main), on the card by the
                    device rule (FLAC_TPU_DEVICE unset), over phase 15's
                    album written as WAV files: `flac -5 -V --replay-gain`
                    over the four in one call (each file's frames
                    byte-identical to phase 15's encode_file stream, the
                    ReplayGain tags equal to phase 15's, the pack,
                    compaction, narrow scan, restore and IIR kernels
                    launched, the IIR once for the album); `flac -t` and
                    `flac -d` to WAV over the four (the WAV bytes equal to
                    the input's) and to AIFF for the longest; `flac --ogg
                    --serial-number=1` of the longest, whose demuxed frames
                    must equal its .flac's, then `flac -t` and `flac -d` of
                    the .oga; SeekableDecoder.decode_range into the .oga and
                    api.Decoder over it as a pipe (its first 200 frames,
                    decoded on the host as flac_tpu's facade does),
                    against slices of the input. Every call must return
                    rc 0, but `flac -t` over two damaged copies of a title,
                    which must report each FAILED with rc 1 (a kernel
                    fault would raise); each prints its wall, Msamples/s a
                    channel and launches.
18. sharded        — the multi-process path (flac_tpu_torch.parallel.sharding)
                    on this one card: (a) one rank on NCCL in this process,
                    joined through a file store, runs encode_corpus_sharded
                    of phase 4's 60 s PCM at 64 frames a step (its SHA-256
                    must be phase 4's) and decode_corpus_sharded of it (the
                    input back), with one pack launch a step and one for the
                    tail frame, two narrow scans and one restore a decode
                    step; (b) two gloo ranks spawned on the same card, each
                    regenerating the PCM from its seed, do the same at 32
                    frames a rank a step, every rank returning phase 4's
                    bytes and the input, and report their walls, launches
                    and collectives back; the collective calls and bytes of
                    one encode step must be the same at 32 and 64 frames a
                    rank; (c) the five examples/torch programs in process on
                    phase 15's shortest title as WAV: their WAVs and PCM
                    equal the input, their .flac files encode_file's
                    streams. Every number of this phase is one card's,
                    whose ranks share it: not a scaling figure.
16. the `kernels` line, printed after phase 18: one entry per ported kernel,
   with its launches on its path (and in phase 17, `launches_cli`; in phase
   18, `launches_sharded`, every rank's; for the merged fill, which no path
   launches, phase 5's direct calls as `launches_direct`), error against the
   plain version, and times.

The last line is the device line {"ok": true, "device": {...}}.
`same_card.py` compares two versions of the port on one card.
"""

from __future__ import annotations

import contextlib
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
API_FRAMES = 200            # frames api.Decoder takes from the Ogg pipe in phase 17
# phase 18: frames a rank a step, for one NCCL rank and for two gloo ranks
# (64 frames a step either way), and the two sizes of one step whose
# collectives must be the same
SHARDED_FPD_NCCL = 64
SHARDED_FPD_GLOO = SHARDED_FPD_NCCL // 2
SHARDED_AUDIT_FPD = (32, 64)
SHARDED_PG_TIMEOUT_S = 120  # each process group's timeout
SHARDED_DEADLINE_S = 300    # the two gloo ranks' deadline, their start included
SHARDED_NOTE = "one card: ranks share it; not a scaling figure"
# the SHA-256 of the streams of phases 4 and 8: a change that alters their
# bytes fails here
SHA256_60S_16BIT_L5 = "42e870d8dfd0eacf428343ecfac8905ae86f67c8a6dd5b6d83470af0fee9847d"
SHA256_30S_24BIT_L8 = "9b9dcefa258eb4f3ea934f8b4a9fdc564db3424c761417c592b662193cad3626"


class _Pipe(io.RawIOBase):
    """An unseekable byte source, as a pipe is: api.Decoder takes its
    bounded chunked path for it."""

    def __init__(self, data: bytes) -> None:
        self._src = io.BytesIO(data)

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def readinto(self, b) -> int:
        return self._src.readinto(b)


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


def mixed_wide_case(words16, pos16, cbps16, guards, rwords, rstarts, rcbps):
    """One batch of len(pos16) subframes that mixes three kinds, so that the
    wide scan's fast path and exact path share a launch: every 8th frame
    from the 3rd a guard string (cycling through `guards`), every 8th from
    the 6th one of random_subframes' starts with a wasted-bits header (its
    first quarter), the others the 16-bit stream's subframes at pos16. The
    parts' words are laid end to end. Returns (words int32, pos int64, cbps
    int64, kind [B] of "stream", "guard", "random")."""
    parts, at = [words16], len(words16)
    guard_at = {}
    for name, w in guards.items():
        guard_at[name] = at
        parts.append(w)
        at += len(w)
    names = list(guards)
    pos, cbps = pos16.astype(np.int64).copy(), cbps16.astype(np.int64).copy()
    kind = np.full(len(pos), "stream", dtype=object)
    n_forced = len(rstarts) // 4
    for i in range(len(pos)):
        if i % 8 == 3:
            name = names[(i // 8) % len(names)]
            pos[i], cbps[i], kind[i] = guard_at[name] * 32, 32 if "32" in name else 16, "guard"
        elif i % 8 == 6:
            j = (i // 8) % n_forced
            pos[i], cbps[i], kind[i] = at * 32 + int(rstarts[j]), int(rcbps[j]), "random"
    parts.append(rwords)
    return np.concatenate(parts).astype(np.int32), pos, cbps, kind


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


def compaction_rows(nbytes, W, seed, garbage=False):
    """words [B, W] int32 of frames of random bytes of the given lengths,
    zero past each frame (as pack writes them) or random there, and their
    total_bits."""
    rng = np.random.default_rng(seed)
    nbytes = np.asarray(nbytes, np.int64)
    raw = rng.integers(0, 256, (len(nbytes), 4 * W), dtype=np.uint8)
    if not garbage:
        raw[np.arange(4 * W)[None, :] >= nbytes[:, None]] = 0
    words = raw.view(">u4").astype(np.uint32).view(np.int32)
    return words, (nbytes * 8).astype(np.int32)


def compaction_edge_cases(silent_words, silent_bits):
    """The edge cases of the compaction's output-driven grid, from seed 2024
    (tests/test_torch_compact_layout.py holds its model of the kernel to them
    on the CPU): (name, words, total_bits) of 4-byte frames at each byte phase, 10-20-byte frames many to a chunk,
    frames ending at each phase, frames of 4*W bytes, one frame, chunk
    boundaries inside a frame and on one, garbage past the tails, the given
    silent frames (a level-5 encode of B=512 zero frames) and 8,192 frames
    (starts beyond 48 KB of shared memory)."""
    rng = np.random.default_rng(2024)
    cases = [(f"four_byte_frames_phase{p}", *compaction_rows([4 + p] + [4] * 700, 2, 10 + p))
             for p in range(4)]
    cases.append(("tiny_frames_many_to_a_chunk",
                  *compaction_rows(rng.integers(10, 21, 512), 5, 20)))
    cases.append(("ends_at_each_phase", *compaction_rows([41] * 96, 11, 21)))
    full = rng.integers(11, 97, 37)
    full[[0, 5, 17, 36]] = 96
    full[4] = 11 + (1 - 11 - full[:4].sum()) % 4
    cases.append(("frames_of_4W_bytes", *compaction_rows(full, 24, 22)))
    cases.append(("one_frame", *compaction_rows([37], 10, 23)))
    cases.append(("chunk_boundaries", *compaction_rows(
        [1000, 1000, 1000, 1200, 1000, 992, 1000, 1000, 1000, 1100, 1000, 999], 300, 24)))
    cases.append(("garbage_past_tails",
                  *compaction_rows(rng.integers(11, 97, 64), 24, 25, garbage=True)))
    cases.append(("silence_512", silent_words, silent_bits))
    cases.append(("frames_8192", *compaction_rows(rng.integers(4, 21, 8192), 5, 26)))
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


def launch_counts() -> dict:
    """Every kernel's launches in this process since its count was zeroed."""
    from flac_tpu_torch.kernels import compact_stream as cst
    from flac_tpu_torch.kernels import iir_scan as iir
    from flac_tpu_torch.kernels import pack_words as pw
    from flac_tpu_torch.kernels import residual_scan as rs
    from flac_tpu_torch.kernels import restore_scan as rr
    return {"pack_words": pw.launches, "pack_words_multi": pw.pack_words_multi.launches,
            "compact_stream": cst.launches, "residual_scan": rs.launches,
            "residual_scan_wide": rs.wide_launches, "restore_scan": rr.launches,
            "iir_scan": iir.launches}


def zero_launch_counts() -> None:
    from flac_tpu_torch.kernels import compact_stream as cst
    from flac_tpu_torch.kernels import iir_scan as iir
    from flac_tpu_torch.kernels import pack_words as pw
    from flac_tpu_torch.kernels import residual_scan as rs
    from flac_tpu_torch.kernels import restore_scan as rr
    pw.launches = pw.pack_words_multi.launches = cst.launches = 0
    rs.launches = rs.wide_launches = rr.launches = iir.launches = 0


def graph_counts() -> tuple[int, int, int]:
    """(eager calls, captures, replays) of the graphed encode steps in this
    process (flac_tpu_torch.graphs)."""
    from flac_tpu_torch import graphs
    return graphs.eager_calls, graphs.captures, graphs.replays


def check_first_encode(label: str, since: tuple, full_batches: int) -> dict:
    """The graph route of an encode_file call that is the first at its
    configuration, with a final partial frame: the batches of full frames
    run eagerly once, are captured at the second batch and replayed from the
    third on; the partial frame's step runs eagerly, once."""
    eager, caps, reps = (a - b for a, b in zip(graph_counts(), since))
    want = (2, 1 if full_batches >= 2 else 0, max(full_batches - 2, 0))
    if (eager, caps, reps) != want:
        raise AssertionError(f"{label}: (eager calls, captures, replays) {(eager, caps, reps)} "
                             f"for {full_batches} batches of full frames, not {want}")
    return {"eager_calls": eager, "captures": caps, "replays": reps}


def graph_edges(fn) -> dict:
    """What a CUDA graph of fn() holds: its nodes, and its edges by type
    (libcuda's cuGraphGetEdges_v2: "default" or "programmatic", the
    edge that a launch with programmatic dependent launch becomes), with
    the kernels at both ends of each programmatic edge. The graph is
    captured, read and dropped, never replayed."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size_p, name_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(
        ctypes.c_char_p)
    for fn_name, args in (("cuGraphGetNodes", [ptr, ptr, size_p]),
                          ("cuGraphGetEdges_v2", [ptr, ptr, ptr, ptr, size_p]),
                          ("cuGraphKernelNodeGetParams_v2", [ptr, ptr]),
                          ("cuFuncGetName", [name_p, ptr]), ("cuKernelGetName", [name_p, ptr])):
        getattr(cu, fn_name).argtypes = args
        getattr(cu, fn_name).restype = ctypes.c_int  # CUresult
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = graph.raw_cuda_graph()
    n_nodes, n_edges = ctypes.c_size_t(0), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n_nodes)) != 0 or \
            cu.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(n_edges)) != 0:
        raise AssertionError("libcuda did not report the graph's nodes and edges")
    src = (ctypes.c_void_p * n_edges.value)()
    dst = (ctypes.c_void_p * n_edges.value)()
    data = (ctypes.c_uint8 * (8 * n_edges.value))()  # CUgraphEdgeData: 8 bytes
    if cu.cuGraphGetEdges_v2(raw, src, dst, data, ctypes.byref(n_edges)) != 0:
        raise AssertionError("cuGraphGetEdges_v2 failed")

    def kernel_name(node) -> str:
        params = (ctypes.c_uint8 * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2
        if cu.cuGraphKernelNodeGetParams_v2(node, params) != 0:
            return "?"
        # the struct's func (offset 0), else its kern (offset 56)
        func, kern = (ctypes.c_void_p.from_buffer(params, off).value for off in (0, 56))
        name = ctypes.c_char_p()
        ok = (cu.cuFuncGetName(ctypes.byref(name), func) == 0 if func
              else cu.cuKernelGetName(ctypes.byref(name), kern) == 0)
        return name.value.decode() if ok and name.value else "?"

    kinds = {0: "default", 1: "programmatic"}
    by_type, programmatic = {}, []
    for i in range(n_edges.value):
        kind = kinds.get(data[8 * i + 2], str(data[8 * i + 2]))
        by_type[kind] = by_type.get(kind, 0) + 1
        if kind == "programmatic":
            programmatic.append([kernel_name(src[i]), kernel_name(dst[i])])
    del graph
    return {"nodes": n_nodes.value, "edges": by_type, "programmatic_edges": programmatic}


def graph_step_check(cfg, frames: np.ndarray, dev, label: str) -> dict:
    """The graphed encode steps on three batches of 64 frames and the
    pool at 512.

    Fresh steps (graphs.GraphedStep) around the eager functions of
    build_frame_encoder_dense and build_frame_encoder run the batches as
    call 1 (eager), call 2 (capture, then one replay) and call 3 (replay);
    each must equal build_frame_encoder_parts composed with the compaction
    on the same batch: the words, total_bits, stream and total. Each call's
    wall and host time (the call's return, before the device is done), 7
    more replays for the steady call, one replay under torch.profiler (the
    device's busy time and events), the pool (memory_reserved before and
    after the capture) and capture time at B=64 and at B=512 (eager, then
    capture of the same batch, equal outputs), and the dense step's graph
    read by graph_edges."""
    from torch.profiler import ProfilerActivity, profile

    from flac_tpu_torch import graphs
    from flac_tpu_torch.encode import packer
    from flac_tpu_torch.encode.frame_encoder import (build_frame_encoder,
                                                     build_frame_encoder_dense,
                                                     build_frame_encoder_parts)

    fields_fn, pack_fn = build_frame_encoder_parts(cfg, device=dev)
    dense_fn = build_frame_encoder_dense(cfg, device=dev).fn
    full_fn = build_frame_encoder(cfg, device=dev).fn
    dense = graphs.GraphedStep(dense_fn, f"{label} dense B=64", dev)
    full = graphs.GraphedStep(full_fn, f"{label} full B=64", dev)

    def timed(step, b, f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(b, f)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return out, (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    calls = []
    for i, kind in enumerate(("eager", "capture", "replay")):
        b, f = frames[64 * i: 64 * (i + 1)], np.arange(64 * i, 64 * (i + 1))
        w_ref, tb_ref = pack_fn(*fields_fn(b, f)[:2])
        s_ref, tot_ref = packer.compact_stream_words_kernel(w_ref, tb_ref)
        (s, tot, tb, _), host_ms, wall_ms = timed(dense, b, f)
        w, tb_full, _ = full(b, f)
        torch.cuda.synchronize()
        equal = (torch.equal(s, s_ref) and int(tot) == int(tot_ref) and torch.equal(tb, tb_ref)
                 and torch.equal(w, w_ref) and torch.equal(tb_full, tb_ref))
        if not equal:
            raise AssertionError(f"{label}: batch {i} ({kind}) through the graphed step "
                                 "differs from the eager parts")
        calls.append({"call": kind, "host_ms": host_ms, "wall_ms": wall_ms,
                      "stream_words_equal": True, "words_equal": True})
    steady = [timed(dense, b, f)[1:] for _ in range(7)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dense(b, f)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    pools = {"B64_dense": graphs.log[-2], "B64_full": graphs.log[-1]}
    dense.release()
    full.release()
    # what the graph makes of the compaction's programmatic dependent launch
    x, fx = torch.as_tensor(frames[:64], device=dev), torch.arange(64, device=dev)
    try:
        edges = graph_edges(lambda: dense_fn(x, fx))
    except Exception as e:  # a reading libcuda or torch cannot give
        edges = {"error": f"{type(e).__name__}: {e}"}
    del x, fx
    big = graphs.GraphedStep(dense_fn, f"{label} dense B=512", dev)
    b, f = frames[:512], np.arange(512)
    eager_out, eager_host, eager_wall = timed(big, b, f)
    graph_out, cap_host, cap_wall = timed(big, b, f)
    if not (torch.equal(eager_out[0], graph_out[0]) and int(eager_out[1]) == int(graph_out[1])):
        raise AssertionError(f"{label}: the B=512 capture differs from its eager call")
    replay_host, replay_wall = timed(big, b, f)[1:]
    pools["B512_dense"] = dict(graphs.log[-1], eager_wall_ms=eager_wall,
                               capture_wall_ms=cap_wall, replay_host_ms=replay_host,
                               replay_wall_ms=replay_wall)
    big.release()
    del eager_out, graph_out
    torch.cuda.empty_cache()
    for p in pools.values():
        p["pool_mb"] = p["pool_bytes"] / 2 ** 20
    return {"calls_64": calls,
            "replay_host_ms": float(np.median([h for h, _ in steady])),
            "replay_wall_ms": float(np.median([w for _, w in steady])),
            "replay_device_busy_ms": busy_ms(spans) if spans else None,
            "replay_device_events": len(spans),
            "pools": pools, "dense_graph": edges}


def run_sharded(mesh, fpd: int, pcm: np.ndarray) -> dict:
    """Phase 18 on one rank: encode_corpus_sharded of `pcm` at level 5 and
    decode_corpus_sharded of the stream, each with its wall, launches and
    collectives; then one encode step at each of SHARDED_AUDIT_FPD, for the
    collective calls and bytes of a step."""
    from flac_tpu_torch.encode.frame_encoder import EncoderConfig
    from flac_tpu_torch.parallel import sharding

    cfg = EncoderConfig.from_level(5, 2, 16, SAMPLE_RATE)
    out = {"ranks": mesh.size(), "frames_per_device": fpd}
    for name in ("encode", "decode"):
        zero_launch_counts()
        sharding.collective_calls = sharding.collective_bytes = 0
        sharding.payload_calls = sharding.payload_bytes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "encode":
            stream = sharding.encode_corpus_sharded(pcm, cfg, mesh, frames_per_device=fpd)
        else:
            got = sharding.decode_corpus_sharded(stream, mesh, frames_per_device=fpd)
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
                     "collective_calls": sharding.collective_calls,
                     "collective_bytes": sharding.collective_bytes,
                     "payload_calls": sharding.payload_calls,
                     "payload_bytes": sharding.payload_bytes}
    out["encode"]["msamples_per_s"] = len(pcm) / out["encode"]["wall_s"] / 1e6
    out["decode"]["msamples_per_s"] = len(pcm) / out["decode"]["wall_s"] / 1e6
    out["stream_sha256"] = hashlib.sha256(stream).hexdigest()
    out["pcm_equal"] = bool(np.array_equal(got, pcm))
    frames = pcm[: (len(pcm) // BLOCKSIZE) * BLOCKSIZE].reshape(-1, BLOCKSIZE, 2)
    r = mesh.get_local_rank("host") * mesh.size(1) + mesh.get_local_rank("chip")
    out["step_collectives"] = {}
    for fpd_a in SHARDED_AUDIT_FPD:
        step = sharding.build_sharded_encode_step(cfg, mesh, fpd_a)
        calls, nbytes = sharding.collective_calls, sharding.collective_bytes
        step(frames[r * fpd_a:(r + 1) * fpd_a], np.arange(r * fpd_a, (r + 1) * fpd_a))
        out["step_collectives"][str(fpd_a)] = [sharding.collective_calls - calls,
                                               sharding.collective_bytes - nbytes]
    return out


def sharded_rank(rank: int, world: int, init_file: str, out_path: str) -> None:
    """One of phase 18's gloo ranks, spawned; every rank runs on this
    process's card (cuda:{LOCAL_RANK % device_count}, LOCAL_RANK unset: the
    first) and regenerates phase 4's PCM from its seed."""
    from datetime import timedelta

    import torch.distributed as dist

    from flac_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=SHARDED_PG_TIMEOUT_S))
    try:
        out = run_sharded(sharding.make_mesh(), SHARDED_FPD_GLOO,
                          make_pcm(SAMPLE_RATE * SECONDS))
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def sharded_phase(card: str, pcm: np.ndarray, title: np.ndarray) -> dict:
    """Phase 18: (a) one NCCL rank in this process, (b) two gloo ranks on
    this card in spawned processes, (c) the five examples/torch programs in
    process on `title`. Raises on any failed check."""
    import multiprocessing
    from datetime import timedelta
    import importlib.util
    import types

    import torch.distributed as dist

    from flac_tpu_torch.containers import AudioBuffer, parse_wav, write_wav
    from flac_tpu_torch.encode.encoder import encode_file
    from flac_tpu_torch.metadata import Padding, VorbisComment
    from flac_tpu_torch.parallel import sharding

    # both runs take SHARDED_FPD_NCCL frames a step (two ranks of SHARDED_FPD_GLOO)
    steps = -(-(len(pcm) // BLOCKSIZE) // SHARDED_FPD_NCCL)

    def check(run: dict, who: str) -> None:
        enc, dec = run["encode"]["launches"], run["decode"]["launches"]
        want_enc = {"pack_words": steps + 1, "residual_scan": 0, "restore_scan": 0}
        want_dec = {"pack_words": 0, "residual_scan": 2 * steps, "restore_scan": steps,
                    "residual_scan_wide": 0}
        if any(enc[k] != v for k, v in want_enc.items()) \
                or any(dec[k] != v for k, v in want_dec.items()):
            raise AssertionError(f"{who}: launches {enc} / {dec}, expected {want_enc} / "
                                 f"{want_dec}")
        if run["stream_sha256"] != SHA256_60S_16BIT_L5 or not run["pcm_equal"]:
            raise AssertionError(f"{who}: stream {run['stream_sha256']}, PCM equal "
                                 f"{run['pcm_equal']}")
        counts = {tuple(v) for v in run["step_collectives"].values()}
        if len(counts) != 1:
            raise AssertionError(f"{who}: a step's collectives grow with frames_per_device: "
                                 f"{run['step_collectives']}")

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    # (a) one rank on NCCL, joined through a file store
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/nccl_store", rank=0,
                            world_size=1, timeout=timedelta(seconds=SHARDED_PG_TIMEOUT_S),
                            device_id=dev)
    try:
        nccl = run_sharded(sharding.make_mesh(), SHARDED_FPD_NCCL, pcm)
    finally:
        dist.destroy_process_group()
    check(nccl, "one NCCL rank")

    # (b) two gloo ranks sharing the card; the kernels were built in phase 1
    ctx = multiprocessing.get_context("spawn")
    outs = [os.path.join(tmp.name, f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=sharded_rank, args=(r, 2, f"{tmp.name}/gloo_store", outs[r]))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(SHARDED_DEADLINE_S - (time.perf_counter() - t0), 1))
    finally:
        late = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    gloo_wall = time.perf_counter() - t0
    if late or any(p.exitcode for p in procs):
        raise AssertionError(f"gloo ranks: past the {SHARDED_DEADLINE_S} s deadline {late}, "
                             f"exit codes {[p.exitcode for p in procs]}")
    gloo = []
    for r, path in enumerate(outs):
        with open(path) as f:
            gloo.append(json.load(f))
        check(gloo[-1], f"gloo rank {r}")

    # (c) the examples, in process on the card (FLAC_TPU_DEVICE is unset)
    here = os.path.dirname(os.path.abspath(__file__))
    wav = os.path.join(tmp.name, "title.wav")
    write_wav(wav, AudioBuffer(samples=title, sample_rate=SAMPLE_RATE, bits_per_sample=16))
    examples = {}

    def example(name: str, argv: list[str], stdin=None) -> bytes:
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", os.path.join(here, "examples", "torch", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        raw = io.BytesIO()
        text = io.StringIO()
        saved = sys.argv, sys.stdin, sys.stdout
        sys.argv = [name, *argv]
        sys.stdout = types.SimpleNamespace(buffer=raw, write=text.write, flush=text.flush)
        if stdin is not None:
            sys.stdin = types.SimpleNamespace(buffer=stdin)
        zero_launch_counts()
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        try:
            rc = mod.main()
        finally:
            torch.cuda.synchronize()
            sys.argv, sys.stdin, sys.stdout = saved
        examples[name] = {"rc": rc, "wall_s": time.perf_counter() - t0_,
                          "launches": launch_counts(), "stdout_tail": text.getvalue()[-300:]}
        if rc != 0:
            raise AssertionError(f"{name}: rc {rc}: {text.getvalue()[-500:]}")
        return raw.getvalue()

    def read(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def same_as_encode_file(path: str, metadata: list) -> None:
        ref = os.path.join(tmp.name, "ref.flac")
        encode_file(title, SAMPLE_RATE, 16, ref, level=5, verify=True, metadata=metadata)
        if read(path) != read(ref):
            raise AssertionError(f"{os.path.basename(path)} differs from encode_file's stream")

    flac_path = os.path.join(tmp.name, "title.flac")
    example("encode_example", [wav, flac_path])
    same_as_encode_file(flac_path, [VorbisComment(vendor_string="", comments=[
        "ARTIST=example", "TITLE=example"]), Padding(length=1024)])
    for name in ("decode_example", "stream_decode_example"):
        out_wav = os.path.join(tmp.name, f"{name}.wav")
        example(name, [flac_path, out_wav])
        if not np.array_equal(parse_wav(read(out_wav)).samples, title):
            raise AssertionError(f"{name}: the WAV differs from the input")
    with open(flac_path, "rb") as f:
        raw = example("pipe_decode_example", [], stdin=f)
    if not np.array_equal(np.frombuffer(raw, "<i4").reshape(-1, 2), title):
        raise AssertionError("pipe_decode_example: the PCM differs from the input")
    oo_path = os.path.join(tmp.name, "oo.flac")
    example("oo_api_example", [wav, oo_path])
    same_as_encode_file(oo_path, [VorbisComment(vendor_string="", comments=[
        "TITLE=oo example"])])
    for name, ex in examples.items():
        need = ("pack_words", "compact_stream") if name in ("encode_example", "oo_api_example") \
            else ("residual_scan", "restore_scan")
        if not all(ex["launches"][k] > 0 for k in need) or ex["launches"]["residual_scan_wide"]:
            raise AssertionError(f"{name} launched {ex['launches']}")
    tmp.cleanup()
    return {"phase": "sharded", "card": card, "note": SHARDED_NOTE,
            "wall_s": time.perf_counter() - t_phase, "steps": steps, "nccl_one_rank": nccl, "gloo_two_ranks": gloo,
            "gloo_wall_s": gloo_wall, "examples": examples,
            "title_samples": len(title), "streams_equal_phase4": True,
            "decodes_equal_input": True, "examples_equal_encode_file": True}


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
    from flac_tpu_torch import api
    from flac_tpu_torch.cli import flac as flac_cli
    from flac_tpu_torch.containers import AudioBuffer, parse_aiff, parse_wav, wav_bytes
    from flac_tpu_torch.ogg import flac_stream_from_ogg

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

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
        since = graph_counts()
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
    graph_route = check_first_encode("the 60 s -5 encode", since, full_batches)
    if launches == 0 or launches != stats.batches:
        raise AssertionError(f"pack kernel launched {launches} times for "
                             f"{stats.batches} frame batches")
    # each batch of full frames is compacted; the final partial frame comes
    # back as its own word row
    if compact_launches != full_batches:
        raise AssertionError(f"compaction kernel launched {compact_launches} times for "
                             f"{full_batches} batches of full frames")
    if stats.frames != n_full + 1 or stats.samples != n:
        raise AssertionError(f"encoded {stats.frames} frames / {stats.samples} samples")
    if hashlib.sha256(data).hexdigest() != SHA256_60S_16BIT_L5:
        raise AssertionError("the 60 s -5 stream differs from the recorded one")
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

    def stage_batch(trace_pack: bool = True, cfg=cfg, frames=frames) -> dict:
        """Where one 64-frame batch of `frames` (encoded with `cfg`) spends
        its time: the two device stages, the pack stage (the step's banded
        fill), and the stream encoder's step, copy back and emit (the
        compacted words, _emit_dense) and the host's MD5 on the host clock; the step's device busy time and event
        count under the profiler, and (trace_pack) the pack stage alone
        under the profiler, where it must be one kernel and no other device
        event."""
        fields_gpu, _ = build_frame_encoder_parts(cfg, device=dev)
        words = max_frame_bytes(cfg, cfg.blocksize) // 4
        tbl, inv = tables(words)

        def pack_gpu(v, nb):  # the step's pack()
            return packer.pack_frames_kernel(v, nb, words, tbl, inv)

        # the step's eager function: these stages stay the eager ones (the
        # graphed steps are timed by graph_step_check)
        enc_dense = build_frame_encoder_dense(cfg, device=dev).fn
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
            emitter.out = io.BytesIO()
            t_a = time.perf_counter()
            MD5Context().accumulate(chunk, cfg.bits_per_sample)
            t_b = time.perf_counter()
            stream, total, tb, _ = enc_dense(frames[:64], fnos_64)
            torch.cuda.synchronize()
            t_c = time.perf_counter()
            th = tb.cpu().numpy()
            total = int(total)
            sh = stream[: (total + 3) // 4].cpu().numpy()
            t_d = time.perf_counter()
            emitter._emit_dense(sh, total, th, 64)
            t_e = time.perf_counter()
            return tuple((y - x) * 1e3 for x, y in
                         ((t_a, t_b), (t_b, t_c), (t_c, t_d), (t_d, t_e))) + (len(sh),)

        staged()
        host_stages()
        runs = [(staged(), host_stages()) for _ in range(7)]  # interleaved
        fields_ms, pack_ms = (float(np.median(s)) for s in zip(*[a for a, _ in runs]))
        md5_ms, batch_ms, copy_ms, emit_ms, words_back = (
            float(np.median(s)) for s in zip(*[b for _, b in runs]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_a = time.perf_counter()
            enc_dense(frames[:64], fnos_64)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t_a) * 1e3
        # the device's own events (kernels, copies, fills); summing
        # key_averages' self device times instead would count each kernel
        # under its op too
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = busy_ms(spans) if spans else None  # None: the trace saw no device
        stages = {"fields_ms": fields_ms, "pack_ms": pack_ms,
                  "encode_wall_ms": batch_ms, "host_md5_ms": md5_ms,
                  "host_copy_back_ms": copy_ms, "host_emit_ms": emit_ms,
                  "copy_back_words": int(words_back),
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
            counted = pw.launches
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
            if pw.launches != counted + 4:
                raise AssertionError("pack() did not launch once a call")
            return traces[0] if traces else []

        # a trace that saw fewer device events than the 3 launches the
        # counters show is a failed reading (the profiler drops events now
        # and then), and is taken again
        pack_events, sessions = pack_trace(), 1
        while len(pack_events) < 3 and sessions < 3:
            pack_events, sessions = pack_trace(), sessions + 1
        if len(pack_events) != 3 or any("pack_frames_kernel" not in e for e in pack_events):
            raise AssertionError(f"3 pack() calls ran {pack_events} "
                                 "on the device, not one pack kernel each")
        return dict(stages, pack_device_events_3_calls=pack_events,
                    pack_trace_sessions=sessions)

    one_batch = stage_batch()
    graphed_batch = graph_step_check(cfg, frames, dev, "level5")
    # the whole encode again, every batch a replay (and the partial frame's
    # capture), then again under the profiler, device activity only: its
    # busy time over an unprofiled run's wall is the run's idle share
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_file(pcm, SAMPLE_RATE, 16, os.path.join(tmp, "r.flac"), level=5)
        torch.cuda.synchronize()
        wall_replayed = time.perf_counter() - t0
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
          "graph_route": graph_route, "wall_s_replayed": wall_replayed,
          "run_device_idle_share_replayed": (None if run_busy_s is None
                                             else 1 - run_busy_s / wall_replayed),
          "cpu_vs_gpu_first_batch": {"frames_differing": diff_frames,
                                     "bytes_differing": diff_bytes},
          "stream_sha256": hashlib.sha256(data).hexdigest(),
          "one_batch_64": one_batch, "graphed_batch_64": graphed_batch})

    # --- 5. verify on the card, and the merged fill on the same batches -----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "verify.flac")
        torch.cuda.synchronize()
        pw.launches = rs.launches = rr.launches = cst.launches = 0
        since = graph_counts()
        t0 = time.perf_counter()
        vstats = encode_file(pcm, SAMPLE_RATE, 16, path, level=5, verify=True)
        torch.cuda.synchronize()
        verify_wall = time.perf_counter() - t0
        # phase 4 left every step of this configuration captured: each call
        # replays, the final partial frame's included
        verify_route = dict(zip(("eager_calls", "captures", "replays"),
                                (a - b for a, b in zip(graph_counts(), since))))
        verify_pack_launches, verify_compact_launches = pw.launches, cst.launches
        verify_launches = (rs.launches, rr.launches)
        with open(path, "rb") as f:
            verify_data = f.read()
    if verify_data != data:
        raise AssertionError("the verify encode's stream differs from phase 4's")
    if list(verify_route.values()) != [0, 0, full_batches + 1]:
        raise AssertionError(f"the verify encode's graph route {verify_route}, not "
                             f"{full_batches + 1} replays")
    if (verify_pack_launches, verify_compact_launches) != (vstats.batches, full_batches):
        raise AssertionError(f"the verify encode launched pack {verify_pack_launches} and "
                             f"the compaction {verify_compact_launches} times for "
                             f"{vstats.batches} batches, {full_batches} of full frames")
    if verify_launches != (2 * full_batches, full_batches):
        raise AssertionError(f"verify launched the decode kernels {verify_launches} "
                             f"times for {full_batches} batches of 2 channels")
    # the merged fill (reached through packer alone) on the fields of the
    # stream's batches of full frames and of its final partial frame: the
    # banded fill's words and bit counts, each fill launched once a batch
    batches = [(fields_fn, frames[s_:s_ + 64], np.arange(s_, min(s_ + 64, n_full)),
                maxwords) for s_ in range(0, n_full, 64)]
    batches.append((tail_fn, pcm[None, -rem:], np.asarray([n_full]),
                    max_frame_bytes(cfg, rem) // 4))
    pw.launches = pw.pack_words_multi.launches = 0
    for fields, pcm_b, fnos_b, words in batches:
        v, nb, _ = fields(pcm_b, fnos_b)
        tbl, inv = tables(words)
        wb, tb = packer.pack_frames_kernel(v, nb, words, tbl, inv)
        wm, tm = packer.pack_frames_kernel(v, nb, words, tbl, inv, merged=True)
        torch.cuda.synchronize()
        if not (torch.equal(wb, wm) and torch.equal(tb, tm)):
            raise AssertionError(f"the merged fill's words differ from the banded fill's "
                                 f"at frame {int(fnos_b[0])}")
    merged_launches = pw.pack_words_multi.launches
    if (pw.launches, merged_launches) != (vstats.batches, vstats.batches):
        raise AssertionError(f"the fills launched ({pw.launches}, {merged_launches}) times "
                             f"for {vstats.batches} batches")
    emit({"phase": "encode_merged", "card": card, "batches": vstats.batches,
          "pack_words_launches": verify_pack_launches,
          "compact_stream_launches": verify_compact_launches,
          "verify_subframe_scan_launches": verify_launches[0],
          "verify_restore_scan_launches": verify_launches[1],
          "bytes_equal_phase4": True, "verify": "passed", "wall_s": verify_wall,
          "graph_route": verify_route,
          "msamples_per_s_per_channel": n / verify_wall / 1e6,
          "pack_words_multi_launches": merged_launches, "words_equal_banded": True})

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
        since = graph_counts()
        t0 = time.perf_counter()
        hstats = encode_file(pcm24, HIRES_RATE, 24, os.path.join(tmp, "h.flac"), level=8,
                             verify=True)
        torch.cuda.synchronize()
        hires_wall = time.perf_counter() - t0
        hires_graph_route = check_first_encode("the 24-bit -8 encode", since,
                                               full_batches24)
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
        raise AssertionError("the 30 s 24-bit -8 stream differs from the recorded one")
    out24, si24, _ = decode_bytes(data24)  # CRC-8, CRC-16 and MD5 checked
    if si24.md5sum == b"\x00" * 16 or not np.array_equal(out24, pcm24):
        raise AssertionError("the 24-bit -8 stream does not decode to its input")
    diff24 = frames_differing(cfg8, frames24[:16], dev)
    if diff24[0]:
        raise AssertionError(f"{diff24[0]} of the first 16 24-bit -8 frames differ "
                             f"between the CPU and the card ({diff24[1]} bytes)")
    one_batch_24 = stage_batch(trace_pack=False, cfg=cfg8, frames=frames24)
    graphed_batch_24 = graph_step_check(cfg8, frames24, dev, "level8_24bit")
    # -p and escape coding on a signal with full-scale bursts
    pcm_pe = burst_pcm(HIRES_RATE * PE_SECONDS, 24, seed=25)
    cfg_pe = EncoderConfig.from_level(8, 2, 24, HIRES_RATE, do_qlp_coeff_prec_search=True,
                                      do_escape_coding=True)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        pw.launches = 0
        since = graph_counts()
        t0 = time.perf_counter()
        pstats = encode_file(pcm_pe, HIRES_RATE, 24, os.path.join(tmp, "pe.flac"), level=8,
                             do_qlp_coeff_prec_search=True, do_escape_coding=True)
        torch.cuda.synchronize()
        pe_wall = time.perf_counter() - t0
        pe_graph_route = check_first_encode("the -p / escape encode", since,
                                            -(-(len(pcm_pe) // BLOCKSIZE) // 64))
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
          "graph_route": hires_graph_route,
          "one_batch_64": one_batch_24, "graphed_batch_64": graphed_batch_24,
          "p_escape": {"seconds_of_audio": PE_SECONDS, "frames": pstats.frames,
                       "batches": pstats.batches, "pack_kernel_launches": pe_launches,
                       "wall_s": pe_wall, "bytes": len(data_pe),
                       "graph_route": pe_graph_route,
                       "stream_sha256": hashlib.sha256(data_pe).hexdigest(),
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
            since = graph_counts()
            t0 = time.perf_counter()
            wstats = encode_file(pcm_w, SAMPLE_RATE, bps, os.path.join(tmp, "w.flac"),
                                 level=5, verify=True)
            torch.cuda.synchronize()
            wwall = time.perf_counter() - t0
            wgraph = check_first_encode(f"the {bps}-bit encode", since, full_batches_w)
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
                          "graph_route": wgraph,
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

    def wide_check(name, words_t, pos_t, cbps_t, T):
        """The wide kernel against wide_residual_scan's composition on every
        output, with the frames it sent to its exact path; returns the
        kernel's outputs and the plain call's seconds."""
        rs.exact_path_frames()
        got = rs.subframe_scan(words_t, pos_t, cbps_t, T, DECODE_MAXORD, wide=True)
        exact_frames = rs.exact_path_frames()
        t_a = time.perf_counter()
        ref = fd.subframe_scan(words_t, pos_t, cbps_t, T, DECODE_MAXORD, wide=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t_a
        n_ovf = int(got[3].sum())
        if exact_frames < n_ovf:
            raise AssertionError(f"{name}: {n_ovf} flagged frames but {exact_frames} "
                                 "on the exact path")
        wcases.append({"case": name, "subframe_scan_max_abs_err": scan_err(got, ref),
                       "overflow_frames": n_ovf, "exact_path_frames": exact_frames})
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
    rows32, timing32 = [], []
    for c in range(2):
        cbps32 = fd.side_channel_bps(assignment, c, 32, 2)
        got, _ = wide_check(f"stream32_{len(offsets32)}x{BLOCKSIZE}_channel{c}", words32,
                            pos, cbps32, BLOCKSIZE)
        timing32.append((pos, cbps32, got[2]))
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
        if bool(got[3][0]) != want_ovf or wcases[-1]["exact_path_frames"] != want_ovf:
            raise AssertionError(f"the wide scan's overflow flag or path is wrong on {name}")
        wcases[-1]["ovf"] = want_ovf
    # 512 random starts in random words with zero runs (phase 6's generator)
    got, _ = wide_check(f"random_{len(rstarts)}x{BLOCKSIZE}", *rargs_rnd[:3], BLOCKSIZE)
    rnd = (got[1], *fd.restore_inputs(got[0], DECODE_MAXORD), BLOCKSIZE, DECODE_MAXORD)
    xk, xp = rr.restore_scan(*rnd), fd.restore_scan(*rnd)
    torch.cuda.synchronize()
    wcases[-1]["restore_scan_max_abs_err"] = err(xk, xp)
    del got, rnd, xk, xp
    # one B=512 launch that mixes the 16-bit stream's frames with the guard
    # strings and phase 6's wasted-run starts: both paths in one launch
    wpos0, wcbps0, wide_end0, wide_plain_s = wide_timing[0]
    mixed = mixed_wide_case(words.cpu().numpy(), wpos0.cpu().numpy(), wcbps0.cpu().numpy(),
                            guard_strings, rw, rstarts, rcbps)
    got, _ = wide_check(f"mixed_{DECODE_B}x{BLOCKSIZE}",
                        *(torch.as_tensor(x, device=dev) for x in mixed[:3]), BLOCKSIZE)
    wcases[-1]["frames"] = {k: int((mixed[3] == k).sum()) for k in ("stream", "guard", "random")}
    if not 0 < wcases[-1]["exact_path_frames"] < DECODE_B:
        raise AssertionError(f"the mixed launch did not share both paths: {wcases[-1]}")
    del got, mixed
    for cse in wcases:
        if any(v for k, v in cse.items() if k.endswith("max_abs_err")):
            raise AssertionError(f"the wide scan or the restore disagrees on {cse}")
    # times, on channel 0 of the 512 real frames: the kernel, its exact path
    # for every frame and the narrow kernel, in turns, by CUDA-graph replay
    # (the kernel is shorter than the launcher's host work late in this
    # process); the plain version's time is its checking call above
    turns = {"wide": [], "exact_path": [], "narrow": []}
    for _ in range(2):
        turns["wide"].append(graph_ms(lambda: rs.subframe_scan(
            words, wpos0, wcbps0, BLOCKSIZE, DECODE_MAXORD, wide=True)))
        turns["exact_path"].append(graph_ms(lambda: rs.subframe_scan(
            words, wpos0, wcbps0, BLOCKSIZE, DECODE_MAXORD, wide=True, exact=True), iters=5))
        turns["narrow"].append(graph_ms(lambda: rs.subframe_scan(
            words, wpos0, wcbps0, BLOCKSIZE, DECODE_MAXORD)))
    wide_ms = turns["wide"][0]
    wide_plain_ms = wide_plain_s * 1e3
    pos32_0, cbps32_0, end32_0 = timing32[0]
    wide32_ms = graph_ms(lambda: rs.subframe_scan(words32, pos32_0, cbps32_0, BLOCKSIZE,
                                                  DECODE_MAXORD, wide=True))

    def wide_bytes_of(pos_a, end_a):
        """The bytes the function must move: the subframes' bits read once,
        res (int64) written once, the per-frame inputs and outputs."""
        n = pos_a.shape[0]
        return (int(((end_a - pos_a).sum() + 7) // 8) + n * BLOCKSIZE * 8
                + n * (16 + 9 * 8 + 5 + 2 * DECODE_MAXORD * 8 + 9))
    wide_bytes = wide_bytes_of(wpos0, wide_end0)
    wide_bound_ms = wide_bytes / HBM_BYTES_PER_S * 1e3
    wide32_bound_ms = wide_bytes_of(pos32_0, end32_0) / HBM_BYTES_PER_S * 1e3
    # the walk's floor: each frame walks its T samples one after another (all
    # 512 frames at once, a block each), one dependent walk step a sample
    walk_ns = (rs.walk_latency_probe(1 << 22) - rs.walk_latency_probe(1 << 21)
               ) / (1 << 21) * 1e6
    wide_latency_bound_ms = BLOCKSIZE * walk_ns * 1e-6
    emit({"phase": "kernels_wide", "card": card, "cases": wcases,
          "timing_shape": {"B": DECODE_B, "T": BLOCKSIZE, "maxord": DECODE_MAXORD},
          "wide_scan": {"kernel_ms": wide_ms, "plain_ms": wide_plain_ms,
                        "bound_ms": wide_bound_ms, "bytes": wide_bytes,
                        "latency_bound_ms": wide_latency_bound_ms,
                        "walk_step_ns": walk_ns, "turns_ms": turns,
                        "stream32": {"frames": int(pos32_0.shape[0]), "kernel_ms": wide32_ms,
                                     "bound_ms": wide32_bound_ms}}})

    # --- 12. kernels_compact: the compaction kernel against its plain version --
    ccases = []
    compact_timing = {}
    enc5 = build_frame_encoder(cfg, device=dev).fn  # eager: no graph pinned for these
    enc8 = build_frame_encoder(cfg8, device=dev).fn
    real_batches = [(f"level5_batch_64x{BLOCKSIZE}", *enc5(frames[:64], np.arange(64))[:2]),
                    (f"level8_24bit_batch_64x{BLOCKSIZE}",
                     *enc8(frames24[:64], np.arange(64))[:2]),
                    (f"level5_batch_{DECODE_B}x{BLOCKSIZE}",
                     *enc5(frames[:DECODE_B], np.arange(DECODE_B))[:2])]
    silent = enc5(np.zeros((DECODE_B, BLOCKSIZE, 2), np.int32), np.arange(DECODE_B))[:2]
    edge_cases = compaction_edge_cases(*silent)
    for name, w_c, tb_c in compaction_cases() + edge_cases + real_batches:
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
                "blocks": cst.grid_blocks(nb, wn),
                "plain_ms": time_ms(lambda: packer.compact_stream_words(w_c, tb_c),
                                    iters=3, warmup=1),
                # masked_select sizes its output from the data, which
                # synchronises: CUDA events around back-to-back calls
                "library_ms": time_ms(lambda: torch.masked_select(rows, keep)),
                "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bytes": c_bytes, "stream_bytes": int(got[1]),
                "padded_bytes": nb * wn * 4}
            del rows, keep, lib_bytes, stream_bytes
    # the least a launch of the B=64 grid costs (the source's empty kernel),
    # and what the compaction adds after pack() on the dense route, where
    # programmatic dependent launch overlaps its launch with pack's tail
    t64 = compact_timing[f"level5_batch_64x{BLOCKSIZE}"]
    fields5, pack5 = build_frame_encoder_parts(cfg, device=dev)
    values64, nbits64 = fields5(frames[:64], np.arange(64))[:2]
    floor = {}
    for pdl in (True, False):
        key = "pdl" if pdl else "plain"
        floor[key] = graph_ms(lambda: cst.launch_probe(t64["blocks"], pdl))
    pack_ms, after = [], {"compact": [], "probe_pdl": [], "probe_plain": []}
    for _ in range(2):  # in turns: pack alone, then each follower after it
        pack_ms.append(graph_ms(lambda: pack5(values64, nbits64)))
        after["compact"].append(graph_ms(lambda: cst.compact_stream(*pack5(values64, nbits64))))
        for pdl in (True, False):
            after["probe_pdl" if pdl else "probe_plain"].append(graph_ms(
                lambda: (pack5(values64, nbits64), cst.launch_probe(t64["blocks"], pdl))))
    pack_alone = min(pack_ms)
    t64["launch_floor_ms"] = floor["pdl"]
    t64["launch_floor_plain_ms"] = floor["plain"]
    t64["pack_ms"] = pack_alone
    t64["after_pack_ms"] = min(after["compact"]) - pack_alone
    t64["probe_after_pack_ms"] = {k[6:]: min(v) - pack_alone for k, v in after.items()
                                  if k.startswith("probe")}
    t64["turns_ms"] = {"pack": pack_ms, **after}
    del real_batches, enc5, enc8, silent, edge_cases, fields5, pack5, values64, nbits64
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

    # --- 17. cli: the flac command over phase 15's album ----------------------
    cli_dir = tempfile.TemporaryDirectory()
    wavs, wav_sha, titles_n = [], [], [len(tp) for tp in titles_pcm]
    t0 = time.perf_counter()
    for k, tp in enumerate(titles_pcm):
        blob = wav_bytes(AudioBuffer(samples=tp, sample_rate=SAMPLE_RATE, bits_per_sample=16))
        wavs.append(os.path.join(cli_dir.name, f"title{k}.wav"))
        wav_sha.append(hashlib.sha256(blob).hexdigest())
        with open(wavs[-1], "wb") as f:
            f.write(blob)
        del blob
    write_wavs_s = time.perf_counter() - t0
    flacs = [w[:-4] + ".flac" for w in wavs]
    longest = int(np.argmax(titles_n))
    oga = os.path.join(cli_dir.name, "longest.oga")
    os.environ.pop("FLAC_TPU_DEVICE", None)  # the port's rule: unset means the card
    cli_steps, cli_stderr = {}, {}

    def cli_step(name, argv, samples, want_rc=0):
        """One in-process `flac` call on the card: its rc (which must be
        `want_rc`), wall, rate, the end of its stderr and the launches of
        each kernel it made."""
        zero_launch_counts()
        err_ = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err_):
            rc_ = flac_cli.main(argv)
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        cli_stderr[name] = err_.getvalue()
        sys.stderr.write(cli_stderr[name])
        cli_steps[name] = {
            "argv": [os.path.basename(a) for a in argv], "rc": rc_,
            "wall_s": wall_, "samples_per_channel": samples,
            "msamples_per_s": samples / wall_ / 1e6, "stderr_tail": err_.getvalue()[-400:],
            "launches": launch_counts()}
        if rc_ != want_rc:
            raise AssertionError(f"flac {' '.join(argv)}: rc {rc_}, {want_rc} expected")
        return cli_steps[name]["launches"]

    album_n = sum(titles_n)
    enc_l = cli_step("encode_album", ["-5", "-V", "--replay-gain", "--", *wavs], album_n)
    if enc_l["iir_scan"] != 1 or not all(enc_l[k] > 0 for k in (
            "pack_words", "compact_stream", "residual_scan", "restore_scan")) \
            or enc_l["residual_scan_wide"]:
        raise AssertionError(f"flac -5 -V --replay-gain launched {enc_l}")
    for k, path_k in enumerate(flacs):
        with open(path_k, "rb") as f:
            cli_data = f.read()
        if cli_data[parse_metadata(cli_data)[1]:] != encoded[k][parse_metadata(encoded[k])[1]:]:
            raise AssertionError(f"{path_k}: the CLI's frames differ from encode_file's")
        want_tags = get_tags(paths[k]).comments
        got_tags = get_tags(path_k).comments
        if [c for c in got_tags if c.startswith("REPLAYGAIN_")] != \
                [c for c in want_tags if c.startswith("REPLAYGAIN_")]:
            raise AssertionError(f"{path_k}: tags {got_tags} against phase 15's {want_tags}")
    ogg_l = cli_step("encode_ogg", ["-5", "--ogg", "--serial-number=1", "-o", oga, "--",
                                    wavs[longest]], titles_n[longest])
    if ogg_l["pack_words"] == 0 or ogg_l["compact_stream"] == 0:
        raise AssertionError(f"flac --ogg launched {ogg_l}")
    with open(oga, "rb") as f:
        oga_data = f.read()
    with open(flacs[longest], "rb") as f:
        flac_longest = f.read()
    native = flac_stream_from_ogg(oga_data)
    if native[parse_metadata(native)[1]:] != flac_longest[parse_metadata(flac_longest)[1]:]:
        raise AssertionError("the .oga's demuxed frames differ from the .flac's")
    if oga_data[14:18] != (1).to_bytes(4, "little"):
        raise AssertionError("the .oga does not carry serial number 1")
    for w in wavs:
        os.remove(w)  # flac -d writes them again
    test_l = cli_step("test_album", ["-t", "--", *flacs], album_n)
    # a damaged copy of the first title, twice (8 bytes inverted at 30% and
    # at 50% of the file): `flac -t` must report each FAILED with rc 1 on
    # the card, where a kernel fault would raise out of main instead
    with open(flacs[0], "rb") as f:
        good = f.read()
    corrupt = []
    for k, frac in enumerate((0.3, 0.5)):
        bad = bytearray(good)
        at = int(len(bad) * frac)
        bad[at:at + 8] = bytes(b ^ 0xFF for b in bad[at:at + 8])
        corrupt.append(os.path.join(cli_dir.name, f"corrupt{k}.flac"))
        with open(corrupt[-1], "wb") as f:
            f.write(bad)
    del good, bad
    cli_step("test_corrupt", ["-t", "--", *corrupt], 2 * titles_n[0], want_rc=1)
    failed = [ln for ln in cli_stderr["test_corrupt"].splitlines() if ": FAILED (" in ln]
    if [ln.split(":")[0] for ln in failed] != [os.path.basename(c) for c in corrupt]:
        raise AssertionError(f"flac -t on damaged copies: {cli_steps['test_corrupt']}")
    dec_l = cli_step("decode_album_wav", ["-d", "--", *flacs], album_n)
    for k, w in enumerate(wavs):
        with open(w, "rb") as f:
            blob = f.read()
        if hashlib.sha256(blob).hexdigest() != wav_sha[k] \
                or not np.array_equal(parse_wav(blob).samples, titles_pcm[k]):
            raise AssertionError(f"flac -d: {w} differs from the input")
        del blob
    aiff_path = flacs[longest][:-5] + ".aiff"
    aiff_l = cli_step("decode_aiff", ["--force-aiff-format", "-d", "--", flacs[longest]],
                      titles_n[longest])
    with open(aiff_path, "rb") as f:
        if not np.array_equal(parse_aiff(f.read()).samples, titles_pcm[longest]):
            raise AssertionError("flac -d --force-aiff-format differs from the input")
    ogg_test_l = cli_step("test_ogg", ["-t", "--", oga], titles_n[longest])
    oga_wav = os.path.join(cli_dir.name, "longest_ogg.wav")
    ogg_dec_l = cli_step("decode_ogg", ["-d", "-o", oga_wav, "--", oga], titles_n[longest])
    with open(oga_wav, "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != wav_sha[longest]:
            raise AssertionError("flac -d of the .oga differs from the input")
    for name_, l_ in (("test_album", test_l), ("decode_album_wav", dec_l),
                      ("decode_aiff", aiff_l), ("test_ogg", ogg_test_l),
                      ("decode_ogg", ogg_dec_l)):
        if l_["residual_scan"] == 0 or l_["restore_scan"] == 0 or l_["residual_scan_wide"]:
            raise AssertionError(f"{name_} launched {l_}")
    # random access into the .oga on the card, and the api facade over it as
    # a pipe, each against slices of the input
    tl = titles_pcm[longest]
    rs.launches = rr.launches = 0
    t0 = time.perf_counter()
    sdec = sk.SeekableDecoder(oga_data)
    oga_ranges = []
    for start, count in ((0, 10 * SAMPLE_RATE), (len(tl) // 2 + 777, 30 * SAMPLE_RATE),
                         (len(tl) - 5000, 5000)):
        got = sdec.decode_range(start, count)
        oga_ranges.append({"start": start, "samples": count,
                           "equal": bool(np.array_equal(got, tl[start:start + count]))})
    torch.cuda.synchronize()
    oga_seek = {"wall_s": time.perf_counter() - t0, "ranges": oga_ranges,
                "residual_scan_launches": rs.launches, "restore_scan_launches": rr.launches}
    if not all(r["equal"] for r in oga_ranges) or rs.launches == 0:
        raise AssertionError(f"SeekableDecoder over the .oga: {oga_seek}")
    api_frames = []
    t0 = time.perf_counter()
    adec = api.Decoder(io.BufferedReader(_Pipe(oga_data)),
                       write_callback=lambda pcm_, fr_: api_frames.append(pcm_))
    adec.process_until_end_of_metadata()
    for _ in range(API_FRAMES):
        if not adec.process_single():
            raise AssertionError("api.Decoder over the Ogg pipe aborted")
    got = np.concatenate(api_frames)
    api_pipe = {"is_ogg": adec.is_ogg, "frames": len(api_frames), "samples": len(got),
                "wall_s": time.perf_counter() - t0, "state": adec.state.name,
                "equal": bool(np.array_equal(got, tl[:len(got)]))}
    if not api_pipe["equal"] or not adec.is_ogg or len(api_frames) != API_FRAMES:
        raise AssertionError(f"api.Decoder over the Ogg pipe: {api_pipe}")
    flac_launches = {k: sum(st_["launches"][k] for st_ in cli_steps.values())
                    for k in enc_l}
    emit({"phase": "cli", "card": card, "titles": len(flacs), "album_samples": album_n,
          "write_wavs_s": write_wavs_s, "steps": cli_steps, "launches": flac_launches,
          "frames_equal_encode_file": True, "tags_equal_phase15": True,
          "decodes_equal_input": True, "ogg_frames_equal_native": True,
          "damaged_copies_failed": failed, "oga_seek": oga_seek, "api_ogg_pipe": api_pipe})
    short_title = titles_pcm[int(np.argmin(titles_n))]  # phase 18's examples
    del titles_pcm, encoded, tl, got, native, oga_data, flac_longest
    cli_dir.cleanup()
    album_dir.cleanup()

    # --- 18. sharded: the multi-process path, and the examples ------------------
    sharded = sharded_phase(card, pcm, short_title)
    emit(sharded)
    sharded_launches = {k: sharded["nccl_one_rank"]["encode"]["launches"][k]
                        + sharded["nccl_one_rank"]["decode"]["launches"][k]
                        + sum(r_["encode"]["launches"][k] + r_["decode"]["launches"][k]
                              for r_ in sharded["gloo_two_ranks"])
                        for k in ("pack_words", "residual_scan", "restore_scan")}
    del short_title

    # --- 16. kernels line ---------------------------------------------------
    def pack_row(name, merged, replaces, main_launches, direct_launches=None):
        row = pack_rows[merged]
        t512, t64 = row["timing"]["B512"], row["timing"]["B64"]
        return {"name": name, "route": "cuda", "kernel": f"pack_frames_kernel<{str(merged).lower()}, true>",
                "source": "flac_tpu_torch/csrc/pack_words.cu", "replaces": replaces,
                "launches": main_launches,
                **({} if direct_launches is None else {"launches_direct": direct_launches}),
                "launches_cli": flac_launches["pack_words_multi" if merged else "pack_words"],
                **({} if merged else {"launches_sharded": sharded_launches["pack_words"]}),
                "bit_exact": all(c["max_abs_err"] == 0 for c in row["cases"]),
                "max_abs_err": max(c["max_abs_err"] for c in row["cases"]),
                "ms": t512["kernel_ms"], "plain_ms": t512["plain_ms"],
                "bound_ms": t512["bound_ms"], "bound_by": t512["bound_by"],
                "library_ms": t512["library_ms"], "ms_b64": t64["kernel_ms"],
                "bound_ms_b64": t64["bound_ms"], "fill_only_ms": t512["fill_only_ms"]}

    ct512 = compact_timing[f"level5_batch_{DECODE_B}x{BLOCKSIZE}"]
    emit({"kernels": [
        pack_row("pack_words", False, "flac_tpu/encode/packer.py:443", launches),
        # no path launches the merged fill: phase 5 calls it directly
        pack_row("pack_words_multi", True, "flac_tpu/encode/packer.py:678", 0,
                 merged_launches), {
        "name": "residual_scan", "route": "cuda", "kernel": "subframe_scan",
        "source": "flac_tpu_torch/csrc/residual_scan.cu",
        "replaces": "flac_tpu/decode/frame_decoder.py:409-456, :291",
        "launches": decode_launches[0], "launches_cli": flac_launches["residual_scan"],
        "launches_sharded": sharded_launches["residual_scan"],
        "bit_exact": True,
        "max_abs_err": max(c.get("subframe_scan_max_abs_err", 0) for c in dcases),
        "ms": scan_ms, "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "restore_scan", "route": "cuda",
        "source": "flac_tpu_torch/csrc/restore_scan.cu",
        "replaces": "flac_tpu/decode/frame_decoder.py:628",
        "launches": decode_launches[1] + lpc_launches,
        "launches_decode": decode_launches[1], "launches_lpc_restore": lpc_launches,
        "launches_cli": flac_launches["restore_scan"],
        "launches_sharded": sharded_launches["restore_scan"],
        "bit_exact": True,
        "max_abs_err": max([c.get("restore_scan_max_abs_err", 0) for c in dcases + wcases]
                           + [lpc_err]),
        "ms": restore_ms, "plain_ms": restore_plain_ms, "bound_ms": restore_bound_ms,
        "bound_by": "bytes" if restore_bytes_ms >= restore_ops_ms else "operations",
        "library_ms": None}, {
        "name": "residual_scan_wide", "route": "cuda", "kernel": "subframe_scan<wide>",
        "source": "flac_tpu_torch/csrc/residual_scan.cu",
        "replaces": "flac_tpu/decode/frame_decoder.py:484-595, :590",
        "launches": wide_decode_launches, "launches_cli": flac_launches["residual_scan_wide"],
        "bit_exact": True,
        "max_abs_err": max(c.get("subframe_scan_max_abs_err", 0) for c in wcases),
        "ms": wide_ms, "plain_ms": wide_plain_ms, "bound_ms": wide_bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "latency_bound_ms": wide_latency_bound_ms,
        "exact_path_ms": turns["exact_path"][0], "narrow_ms_same_frames": turns["narrow"][0],
        "ms_32bit": wide32_ms}, {
        "name": "compact_stream", "route": "cuda", "kernel": "compact_stream_kernel",
        "source": "flac_tpu_torch/csrc/compact_stream.cu",
        "replaces": "flac_tpu/encode/packer.py:181",
        "launches": compact_launches, "launches_cli": flac_launches["compact_stream"],
        "bit_exact": True,
        "max_abs_err": max(c["max_abs_err"] for c in ccases),
        "ms": ct512["kernel_ms"], "plain_ms": ct512["plain_ms"],
        "bound_ms": ct512["bound_ms"], "bound_by": "bytes",
        "library_ms": ct512["library_ms"],
        "ms_b64": compact_timing[f"level5_batch_64x{BLOCKSIZE}"]["kernel_ms"],
        "bound_ms_b64": compact_timing[f"level5_batch_64x{BLOCKSIZE}"]["bound_ms"],
        "ms_24bit_b64": compact_timing[f"level8_24bit_batch_64x{BLOCKSIZE}"]["kernel_ms"],
        "launch_floor_ms": compact_timing[f"level5_batch_64x{BLOCKSIZE}"]["launch_floor_ms"],
        "after_pack_ms": compact_timing[f"level5_batch_64x{BLOCKSIZE}"]["after_pack_ms"]}, {
        "name": "iir_scan", "route": "cuda", "kernel": "equal_loudness_kernel",
        "source": "flac_tpu_torch/csrc/iir_scan.cu",
        "replaces": "flac_tpu/replaygain/__init__.py:73",
        "launches": album_launches, "launches_metaflac": cli_launches,
        "launches_cli": flac_launches["iir_scan"],
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
