#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. env     — requires CUDA; prints the card's name and power limit as
             nvidia-smi gives them, and builds the CUDA kernels from csrc/.
2. kernels — holds the word-fill kernel against its plain PyTorch version
             on the card, bit for bit: the cases of
             tests/test_packer_pallas.py, regenerated from their seeds, and
             the real fields of one level-5 batch (B=64, T=4096, stereo)
             and of the stream's final partial block.
             Then times kernel, plain version and one index_add_ call (the
             library yardstick, which the port never calls) at B=512,
             T=4096, with CUDA events after warm-up.
3. encode  — the main path: encode_file(level=5) of 60 s of 44.1 kHz
             stereo 16-bit PCM made from a seed, on the card; the kernel's
             launch count must equal the number of frame batches (the final
             partial block included). The file is decoded by the port's
             host decoder (CRC-8, CRC-16 and MD5 checked) and must give the
             PCM back. The first batch is also encoded on the CPU, and the
             frames that differ are counted (float sums may round apart).
             One 64-frame batch is timed by stage on the host clock (the
             two device stages; the host's MD5, copy back and emit) and
             once under torch.profiler (device busy time, device events);
             the idle share divides the busy time by the unprofiled wall.
             The whole encode runs once more under torch.profiler (device
             only); its busy time over the first run's wall gives the
             run's idle share.
4. the `kernels` line, one entry per ported kernel, with its launches on
   the main path, error against the plain version, and times.

The last line is the device line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
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
MASK32 = 0xFFFFFFFF


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def make_pcm(n: int, seed: int = 0) -> np.ndarray:
    """Stereo 16-bit test music: a sine mix per channel plus noise (in the
    style of tests/conftest.make_signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = (1 << 15) - 1
    out = np.zeros((n, 2), np.int32)
    for c in range(2):
        f1, f2 = 441.0 * (c + 1), 1234.5 + 100 * c
        x = (0.6 * np.sin(2 * np.pi * f1 * t / SAMPLE_RATE)
             + 0.3 * np.sin(2 * np.pi * f2 * t / SAMPLE_RATE))
        noisy = np.round(x * amp * 0.8 + rng.normal(0, 64, n))
        out[:, c] = np.clip(noisy, -amp - 1, amp).astype(np.int32)
    return out


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
    from flac_tpu_torch.decode.host_decoder import decode_bytes
    from flac_tpu_torch.encode import packer
    from flac_tpu_torch.encode.encoder import StreamEncoder, encode_file
    from flac_tpu_torch.encode.frame_encoder import (
        EncoderConfig, build_frame_encoder, build_frame_encoder_parts,
        max_frame_bytes)
    from flac_tpu_torch.kernels import _build
    from flac_tpu_torch.kernels import pack_words as pw
    from flac_tpu_torch.md5 import MD5Context

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # --- 1. env -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    card = f"{kind}, {smi.splitlines()[0].split(',')[-1].strip()}"
    t0 = time.perf_counter()
    _build.build("pack_words")
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "card": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "native_runtime": _native.available,
          "build_s": build_s,
          "ptxas": _build.build_log.get("pack_words", {}).get("ptxas", "cached")})

    # --- 2. kernel against plain version ------------------------------------
    def u32(t):
        return t.to(torch.int64) & MASK32

    def check(name, values, nbits, maxwords):
        v = torch.as_tensor(values, dtype=torch.int64, device=dev)
        n = torch.as_tensor(nbits, dtype=torch.int32, device=dev)
        wk, tk = packer.pack_fields_kernel(v, n, maxwords)
        wp, tp = packer.pack_fields(v, n, maxwords)
        torch.cuda.synchronize()
        err = int((u32(wk) - u32(wp)).abs().max())
        if err or not torch.equal(tk, tp):
            raise AssertionError(f"pack kernel disagrees on {name}: max err {err}")
        return {"case": name, "shape": list(v.shape), "maxwords": maxwords,
                "max_abs_err": err}

    cases = [check(*c) for c in packer_cases()]
    pcm = make_pcm(SAMPLE_RATE * SECONDS)
    cfg = EncoderConfig.from_level(5, 2, 16, SAMPLE_RATE)
    fields_fn, _ = build_frame_encoder_parts(cfg, device=dev)
    maxwords = max_frame_bytes(cfg, BLOCKSIZE) // 4
    frames = pcm[: (len(pcm) // BLOCKSIZE) * BLOCKSIZE].reshape(-1, BLOCKSIZE, 2)
    v64, n64, _ = fields_fn(frames[:64], np.arange(64))
    cases.append(check("level5_batch_64x4096", v64, n64, maxwords))
    del v64, n64
    # the stream's final partial block, which encode_file packs on its own
    rem = len(pcm) - frames.shape[0] * BLOCKSIZE
    tail_fn, _ = build_frame_encoder_parts(cfg, blocksize=rem, device=dev)
    vt, nt, _ = tail_fn(pcm[None, -rem:], np.asarray([frames.shape[0]]))
    cases.append(check(f"level5_partial_1x{rem}", vt, nt,
                       max_frame_bytes(cfg, rem) // 4))
    del vt, nt

    B = 512
    values, nbits, _ = fields_fn(frames[:B], np.arange(B))
    F = values.shape[1]
    ends = torch.cumsum(nbits, dim=1, dtype=torch.int32)
    cases.append(check(f"level5_batch_{B}x{BLOCKSIZE}", values, nbits, maxwords))
    kernel_ms = time_ms(lambda: pw.pack_words(values, ends, maxwords))
    plain_ms = time_ms(lambda: packer.pack_fields(values, nbits, maxwords))
    # library yardstick: one index_add_ of the precomputed word contributions
    we = ((ends - 1) >> 5).to(torch.int64)
    r = ends.to(torch.int64) - (we << 5)
    has = nbits > 0
    vv = torch.where(has, values, 0)
    c0 = torch.where(has, (vv << (32 - r)) & MASK32, 0)
    c1 = (vv >> r) & MASK32
    rowbase = torch.arange(B, device=dev, dtype=torch.int64)[:, None] * maxwords
    dummy = B * maxwords
    i0 = torch.where(has & (we < maxwords), rowbase + we, dummy)
    i1 = torch.where(has & (we >= 1) & (we - 1 < maxwords), rowbase + we - 1, dummy)
    idx = torch.cat([i0.flatten(), i1.flatten()])
    src = torch.cat([c0.flatten(), c1.flatten()])

    def library():
        return torch.zeros(dummy + 1, dtype=torch.int64, device=dev).index_add_(0, idx, src)

    lib_words = library()[:dummy].reshape(B, maxwords)
    if not torch.equal(lib_words & MASK32, u32(pw.pack_words(values, ends, maxwords))):
        raise AssertionError("index_add_ yardstick disagrees with the kernel")
    library_ms = time_ms(library)
    # what the function must move: values and ends read once (a field's
    # nbits is its end less the previous end), the words written once
    bytes_moved = B * F * (8 + 4) + B * maxwords * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    del values, nbits, ends, we, r, has, vv, c0, c1, i0, i1, idx, src, lib_words
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": card, "cases": cases,
          "timing_shape": {"B": B, "F": F, "maxwords": maxwords},
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": bound_ms, "bytes": bytes_moved})

    # --- 3. main path: encode_file on the card ------------------------------
    n = len(pcm)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.flac")
        torch.cuda.synchronize()
        pw.launches = 0
        t0 = time.perf_counter()
        stats = encode_file(pcm, SAMPLE_RATE, 16, path, level=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pw.launches
        with open(path, "rb") as f:
            data = f.read()
    n_full = n // BLOCKSIZE
    if launches == 0 or launches != stats.batches:
        raise AssertionError(f"pack kernel launched {launches} times for "
                             f"{stats.batches} frame batches")
    if stats.frames != n_full + 1 or stats.samples != n:
        raise AssertionError(f"encoded {stats.frames} frames / {stats.samples} samples")
    t1 = time.perf_counter()
    out, si, dframes = decode_bytes(data)  # checks CRC-8, CRC-16 and MD5
    decode_s = time.perf_counter() - t1
    if si.md5sum == b"\x00" * 16 or not np.array_equal(out, pcm):
        raise AssertionError("decoded PCM differs from the input")

    # the first batch again, on the CPU and on the card
    enc_cpu = build_frame_encoder(cfg, device="cpu")
    enc_gpu = build_frame_encoder(cfg, device=dev)
    fnos = np.arange(64)
    wc, tc, _ = enc_cpu(frames[:64], fnos)
    wg, tg, _ = enc_gpu(frames[:64], fnos)
    wg, tg = wg.cpu(), tg.cpu()
    diff_frames = diff_bytes = 0
    for i in range(64):
        a = wc[i].numpy().astype(">u4").tobytes()[: int(tc[i]) // 8]
        b = wg[i].numpy().astype(">u4").tobytes()[: int(tg[i]) // 8]
        if a != b:
            diff_frames += 1
            m = min(len(a), len(b))
            diff_bytes += int((np.frombuffer(a[:m], np.uint8)
                               != np.frombuffer(b[:m], np.uint8)).sum()) + abs(len(a) - len(b))

    # where one batch's time goes: the two device stages and the host's
    # MD5, copy back and emit on the host clock, then the device's busy
    # time and event count from the profiler
    fields_gpu, pack_gpu = build_frame_encoder_parts(cfg, device=dev)
    emitter = StreamEncoder(cfg, io.BytesIO(), device=dev)
    chunk = pcm[: 64 * BLOCKSIZE]

    def staged():
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        v, nb, _ = fields_gpu(frames[:64], fnos)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        pack_gpu(v, nb)
        torch.cuda.synchronize()
        return (t_b - t_a) * 1e3, (time.perf_counter() - t_b) * 1e3

    def host_stages():
        t_a = time.perf_counter()
        MD5Context().accumulate(chunk, 16)
        t_b = time.perf_counter()
        w, tb, _ = enc_gpu(frames[:64], fnos)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        wh, th = w.cpu().numpy(), tb.cpu().numpy()
        t_d = time.perf_counter()
        emitter._emit(wh, th, 64)
        t_e = time.perf_counter()
        return tuple((y - x) * 1e3 for x, y in
                     ((t_a, t_b), (t_b, t_c), (t_c, t_d), (t_d, t_e)))

    staged()
    host_stages()
    runs = [(staged(), host_stages()) for _ in range(7)]  # interleaved
    fields_ms, pack_ms = (float(np.median(s)) for s in zip(*[a for a, _ in runs]))
    md5_ms, batch_ms, copy_ms, emit_ms = (
        float(np.median(s)) for s in zip(*[b for _, b in runs]))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        enc_gpu(frames[:64], fnos)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t_a) * 1e3
    # the device's own events (kernels, copies, fills); summing key_averages'
    # self device times instead would count each kernel under its op too
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = busy_ms(spans) if spans else None  # None: the trace saw no device
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
          "wall_s": wall, "msamples_per_s_per_channel": n / wall / 1e6,
          "compression_ratio": len(data) / (n * 2 * 2), "bytes": len(data),
          "decode_s": decode_s, "lossless": True,
          "run_device_busy_s": run_busy_s, "run_device_events": len(run_spans),
          "run_device_idle_share": (None if run_busy_s is None
                                    else 1 - run_busy_s / wall),
          "cpu_vs_gpu_first_batch": {"frames_differing": diff_frames,
                                     "bytes_differing": diff_bytes},
          "one_batch_64": {"fields_ms": fields_ms, "pack_ms": pack_ms,
                           "encode_wall_ms": batch_ms,
                           "host_md5_ms": md5_ms, "host_copy_back_ms": copy_ms,
                           "host_emit_ms": emit_ms,
                           "profiled_wall_ms": profiled_ms,
                           "device_busy_ms": device_ms,
                           "device_events": len(spans),
                           # busy time over the unprofiled wall; the
                           # profiled wall gives an upper reading
                           "device_idle_share": (None if device_ms is None
                                                 else 1 - device_ms / batch_ms),
                           "device_idle_share_profiled": (
                               None if device_ms is None
                               else 1 - device_ms / profiled_ms)}})

    # --- 4. kernels line ----------------------------------------------------
    emit({"kernels": [{
        "name": "pack_words", "route": "cuda",
        "source": "flac_tpu_torch/csrc/pack_words.cu",
        "replaces": "flac_tpu/encode/packer.py:443",
        "launches": launches,
        "bit_exact": all(c["max_abs_err"] == 0 for c in cases),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
