#!/usr/bin/env python3
"""Variants of the port's dense compaction kernel on one NVIDIA GPU, in one
process.

    python3 tools/torch_compact_variants.py [--other DIR ...]

Builds flac_tpu_torch/csrc/compact_stream.cu as it is and edited copies of
it (EDITS: 64 or 256 threads a block, one block a chunk whatever the
batch, the launch without programmatic dependent launch, and a diagnostic
copy without the search and loads), plus each DIR's
flac_tpu_torch/csrc/compact_stream.cu (another version's kernel with the
same C interface, such as an unpacked `git archive` of an earlier commit),
each with one nvcc into a temporary directory, all started together.
Holds every variant against packer.compact_stream_words, bit for bit, on chip_smoke.py's compaction cases, its edge cases and three real
batches (level-5 B=64 and B=512, 24-bit -8 B=64), then times each by
CUDA-graph replay on the real batches, and after pack() at B=64 (a graph of
pack then compaction, less one of pack alone), in two rounds (the variants
in order, then reversed); the diagnostic copy is timed, not checked. Then
the launch floor: the source's empty kernel on each batch's grid and on one
block, with and without programmatic dependent launch, alone and after
pack(). Prints the card's name and power limit, ptxas's report of the
source, one JSON line a variant and one of the floors. Needs CUDA; raises
otherwise.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from flac_tpu_torch.encode import packer  # noqa: E402
from flac_tpu_torch.encode.frame_encoder import (  # noqa: E402
    EncoderConfig, build_frame_encoder, build_frame_encoder_parts)
from flac_tpu_torch.kernels import _build  # noqa: E402

SOURCE = os.path.join(ROOT, "flac_tpu_torch", "csrc", "compact_stream.cu")
# the lines the edited copies change, and what each becomes
EDITS = {
    "threads64": ("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
    "threads256": ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
    "one_block_a_chunk": ("nchunks < cap ? nchunks : cap", "nchunks"),
    "no_pdl": ("smem, 1, stream,", "smem, 0, stream,"),
    # not the function: the launch, the wait, the scan and the zero stores
    # alone, without the search, the loads and the shifts
    "scan_and_zeros": ("if (k0 < nv) {", "if (k0 < 0) {"),
}
DIAGNOSTIC = {"scan_and_zeros"}


def variants(others: list[str]) -> dict[str, str]:
    """name -> CUDA source: the source as it is, its edited copies, and
    each other directory's source under the directory's name."""
    with open(SOURCE) as f:
        src = f.read()
    out = {"as_is": src}
    for name, (old, new) in EDITS.items():
        if old not in src:
            raise RuntimeError(f"compact_stream.cu no longer has the line {name} edits")
        out[name] = src.replace(old, new)
    for d in others:
        with open(os.path.join(d, "flac_tpu_torch", "csrc", "compact_stream.cu")) as f:
            out[os.path.basename(os.path.normpath(d))] = f.read()
    return out


def build(name: str, src: str, tmp: str) -> ctypes.CDLL:
    cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.flac_compact_stream.restype = ctypes.c_int
    lib.flac_compact_stream.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 2 + [
        ctypes.c_void_p]
    lib.ptxas = (r.stdout + r.stderr).strip()
    return lib


def compact(lib: ctypes.CDLL, words: torch.Tensor, total_bits: torch.Tensor):
    B, W = words.shape
    out = torch.empty(B * W, dtype=torch.int32, device=words.device)
    total = torch.empty((), dtype=torch.int64, device=words.device)
    rc = lib.flac_compact_stream(words.data_ptr(), total_bits.data_ptr(), out.data_ptr(),
                                 total.data_ptr(), B, W,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out, total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="a directory holding another version of the repo (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()
    print(card, flush=True)
    srcs = variants(args.other)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(srcs)) as pool:
        futures = {n: pool.submit(build, n, s, tmp) for n, s in srcs.items()}
        libs = {n: f.result() for n, f in futures.items()}

    cfg = EncoderConfig.from_level(5, 2, 16, cs.SAMPLE_RATE)
    pcm = cs.make_pcm(cs.SAMPLE_RATE * cs.SECONDS)
    frames = pcm[: (len(pcm) // cs.BLOCKSIZE) * cs.BLOCKSIZE].reshape(-1, cs.BLOCKSIZE, 2)
    pcm24 = cs.make_pcm(cs.HIRES_RATE * cs.HIRES_SECONDS, seed=24, rate=cs.HIRES_RATE,
                        bits=24)
    frames24 = pcm24[: 64 * cs.BLOCKSIZE].reshape(-1, cs.BLOCKSIZE, 2)
    enc5 = build_frame_encoder(cfg, device=dev)
    enc8 = build_frame_encoder(EncoderConfig.from_level(8, 2, 24, cs.HIRES_RATE), device=dev)
    fields5, pack5 = build_frame_encoder_parts(cfg, device=dev)
    values64, nbits64 = fields5(frames[:64], np.arange(64))[:2]
    real = [("level5_b64", *enc5(frames[:64], np.arange(64))[:2]),
            ("level8_24bit_b64", *enc8(frames24, np.arange(64))[:2]),
            ("level5_b512", *enc5(frames[:cs.DECODE_B], np.arange(cs.DECODE_B))[:2])]
    silent = enc5(np.zeros((cs.DECODE_B, cs.BLOCKSIZE, 2), np.int32),
                  np.arange(cs.DECODE_B))[:2]
    cases = [(n, torch.as_tensor(w, device=dev), torch.as_tensor(t, device=dev))
             for n, w, t in cs.compaction_cases() + cs.compaction_edge_cases(*silent) + real]
    refs = {n: packer.compact_stream_words(w, t) for n, w, t in cases}
    print(json.dumps({"ptxas_as_is": libs["as_is"].ptxas}), flush=True)
    for name, lib in libs.items():
        if name in DIAGNOSTIC:
            continue
        for n, w, t in cases:
            got = compact(lib, w, t)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], refs[n][0]) and int(got[1]) == int(refs[n][1])):
                raise AssertionError(f"variant {name} disagrees on {n}")

    times = {n: {r[0]: [] for r in real} | {"after_pack": []} for n in libs}
    order = list(libs)
    for rnd in (order, order[::-1]):
        pack_ms = cs.graph_ms(lambda: pack5(values64, nbits64))
        for name in rnd:
            lib = libs[name]
            for n, w, t in real:
                times[name][n].append(cs.graph_ms(lambda: compact(lib, w, t)))
            times[name]["after_pack"].append(
                cs.graph_ms(lambda: compact(lib, *pack5(values64, nbits64))) - pack_ms)
    for name in order:
        print(json.dumps({"variant": name, "card": card, "bit_exact": name not in DIAGNOSTIC,
                          "ms": times[name]}), flush=True)
    # the launch floor: the as-is source's empty kernel on each batch's grid
    probe = libs["as_is"]
    probe.flac_compact_launch_probe.restype = ctypes.c_int
    probe.flac_compact_launch_probe.argtypes = [ctypes.c_int32] * 2 + [ctypes.c_void_p]
    probe.flac_compact_stream_blocks.restype = ctypes.c_int
    probe.flac_compact_stream_blocks.argtypes = [ctypes.c_int32] * 2

    def launch_probe(blocks, pdl):
        if probe.flac_compact_launch_probe(blocks, pdl,
                                           torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("probe launch failed")

    floor = {}
    grids = [(n, probe.flac_compact_stream_blocks(*w.shape)) for n, w, _ in real]
    for n, blocks in grids + [("one_block", 1)]:
        floor[n] = {"blocks": blocks}
        for pdl in (1, 0):
            floor[n]["pdl" if pdl else "plain"] = cs.graph_ms(lambda: launch_probe(blocks, pdl))
    floor["after_pack"] = {
        ("pdl" if pdl else "plain"): cs.graph_ms(lambda: (
            pack5(values64, nbits64),
            launch_probe(grids[0][1], pdl)))
        - pack_ms for pdl in (1, 0)}
    print(json.dumps({"launch_floor_ms": floor, "pack_ms": pack_ms}), flush=True)


if __name__ == "__main__":
    main()
