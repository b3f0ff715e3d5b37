#!/usr/bin/env python3
"""Two versions of the PyTorch/CUDA port on one GPU, in turns.

    python3 same_card.py OTHER_DIR

OTHER_DIR is an unpacked checkout of another version (for example a
`git archive` of its commit in the gitignored archive_check/). The script
runs OTHER_DIR's chip_smoke.py, this checkout's, this one's again and
OTHER_DIR's again, one after the other on one card. After each run a fresh
process in the same checkout (`same_card.py --probe`, with that checkout's
flac_tpu_torch and this checkout's timing code) takes:

- the 60 s level-5 stream of chip_smoke.py's main path and its SHA-256;
- the wall of 5 more encodes of it, and the device's idle share of one
  more under torch.profiler (its busy time over the median wall);
- the SHA-256 of chip_smoke.py's 30 s 24-bit -8 stream, of its 10 s -p and
  escape-coding stream and of its 28- and 32-bit streams, and the wall of 3
  more encodes of the 24-bit stream;
- the device time of that version's pack stage with each fill
  (packer.pack_frames_kernel, banded and merged), of its fill-only
  wrappers (packer.pack_fields_kernel, packer.pack_fields_merged_kernel)
  and of its fill kernel's launches alone, their inputs staged beforehand,
  on build_frame_encoder_parts' fields at B=64 and B=512, by replays of a
  CUDA graph (chip_smoke.graph_ms).

The logs go to same_card_logs/ in this checkout. Every SHA-256 that a run
of chip_smoke.py prints (a key ending in "sha256" in its JSON lines) is
compared with the same key of the other runs that print it. The last line is
one JSON object with each run's exit code, card and probe; the exit code is
0 when every run passed and every stream was byte-identical.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOGS = os.path.join(HERE, "same_card_logs")


def _this_chip_smoke():
    """This checkout's chip_smoke.py, loaded by path, so that every version
    is timed by the same code."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fill_launches(pw, packer, merged, values, nbits, maxwords):
    """The fill kernel's launches alone, as a callable, with what the
    launcher takes staged beforehand. The launchers that came before the
    fused kernel took cumsum(nbits) (and cleared their output), and the
    merged one the three slot arrays of packer.merged_slots, one launch each
    into one cleared buffer."""
    import torch
    if "ends" not in inspect.signature(pw.pack_words).parameters:
        launch = pw.pack_words_multi if merged else pw.pack_words
        return lambda: launch(values, nbits, maxwords)
    if not merged:
        ends = torch.cumsum(nbits, -1, dtype=torch.int32)
        return lambda: pw.pack_words(values, ends, maxwords)
    slots = [(v.contiguous(), e.to(torch.int32).contiguous())
             for v, e in packer.merged_slots(values, nbits)[0]]
    words = torch.zeros((values.shape[0], maxwords), dtype=torch.int32,
                        device=values.device)

    def launches():
        for v, e in slots:
            pw.pack_words_multi(v, e, words)
    return launches


def probe() -> dict:
    """Runs in the checkout under test (the working directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from flac_tpu_torch.encode import packer
    from flac_tpu_torch.encode.encoder import encode_file
    from flac_tpu_torch.encode.frame_encoder import (EncoderConfig,
                                                     build_frame_encoder_parts)
    from flac_tpu_torch.kernels import pack_words as pw
    cs = _this_chip_smoke()
    out = {}
    pcm = cs.make_pcm(cs.SAMPLE_RATE * cs.SECONDS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.flac")
        encode_file(pcm, cs.SAMPLE_RATE, 16, path, level=5)
        with open(path, "rb") as f:
            out["stream_sha256"] = hashlib.sha256(f.read()).hexdigest()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_file(pcm, cs.SAMPLE_RATE, 16, path, level=5)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            encode_file(pcm, cs.SAMPLE_RATE, 16, path, level=5)
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = cs.busy_ms(spans) / 1e3 if spans else None
        out["encode_device_busy_s"] = busy_s
        out["encode_device_idle_share"] = (None if busy_s is None else
                                           1 - busy_s / float(np.median(walls)))
        pcm24 = cs.make_pcm(cs.HIRES_RATE * cs.HIRES_SECONDS, seed=24, rate=cs.HIRES_RATE,
                            bits=24)
        hires = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_file(pcm24, cs.HIRES_RATE, 24, path, level=8)
            torch.cuda.synchronize()
            hires.append(time.perf_counter() - t0)
            with open(path, "rb") as f:
                out["hires_stream_sha256"] = hashlib.sha256(f.read()).hexdigest()
        out["hires_encode_wall_s"] = hires[1:]
        out["hires_encode_wall_s_median"] = float(np.median(hires[1:]))
        encode_file(cs.burst_pcm(cs.HIRES_RATE * cs.PE_SECONDS, 24, seed=25), cs.HIRES_RATE,
                    24, path, level=8, do_qlp_coeff_prec_search=True, do_escape_coding=True)
        with open(path, "rb") as f:
            out["p_escape_stream_sha256"] = hashlib.sha256(f.read()).hexdigest()
        for bps in (28, 32):
            encode_file(cs.make_pcm(cs.SAMPLE_RATE * cs.WIDE_SECONDS, seed=bps, bits=bps,
                                    sigma=2.0 ** 18), cs.SAMPLE_RATE, bps, path, level=5)
            with open(path, "rb") as f:
                out[f"wide{bps}_stream_sha256"] = hashlib.sha256(f.read()).hexdigest()
    out["encode_wall_s"] = walls
    out["encode_wall_s_median"] = float(np.median(walls))
    cfg = EncoderConfig.from_level(5, 2, 16, cs.SAMPLE_RATE)
    frames = pcm[: len(pcm) // cs.BLOCKSIZE * cs.BLOCKSIZE].reshape(-1, cs.BLOCKSIZE, 2)
    fills = {"pallas": packer.pack_fields_kernel, "merged": packer.pack_fields_merged_kernel}
    fields_fn, pack_fn = build_frame_encoder_parts(cfg, device="cuda")
    for B in (64, 512):
        v, n, _ = fields_fn(frames[:B], np.arange(B))
        maxwords = pack_fn(v, n)[0].shape[1]
        tbl, inv = (torch.as_tensor(t, device="cuda")
                    for t in packer.crc16_word_tables(maxwords))
        for impl, fill in fills.items():
            merged = impl == "merged"
            out[f"pack_graph_ms_{impl}_B{B}"] = cs.graph_ms(
                lambda: packer.pack_frames_kernel(v, n, maxwords, tbl, inv, merged))
            out[f"fill_graph_ms_{impl}_B{B}"] = cs.graph_ms(lambda: fill(v, n, maxwords))
            out[f"kernel_graph_ms_{impl}_B{B}"] = cs.graph_ms(
                _fill_launches(pw, packer, merged, v, n, maxwords))
    return out


def printed_sha256(log: str) -> dict:
    """Every "...sha256" value in the JSON lines of a chip_smoke.py log, by
    its path of keys."""
    found = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                if isinstance(v, str) and k.endswith("sha256"):
                    found["/".join(path + [k])] = v
                else:
                    walk(v, path + [k])
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                walk(v, path + [str(i)])

    with open(log) as f:
        for line in f:
            if line.startswith("{"):
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                walk(obj, [str(obj.get("phase", "?"))])
    return found


def main(other: str) -> int:
    other = os.path.abspath(other)
    os.makedirs(LOGS, exist_ok=True)
    runs = []
    for i, (label, tree) in enumerate([("other", other), ("this", HERE),
                                       ("this", HERE), ("other", other)]):
        log = os.path.join(LOGS, f"{i}_{label}.txt")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f,
                                stderr=subprocess.STDOUT, timeout=1200).returncode
        with open(log) as f:
            card = next((ln for ln in f.read().splitlines()
                         if not ln.startswith("{") and ln.rstrip().endswith(" W")), None)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--probe"],
                           cwd=tree, capture_output=True, text=True, timeout=900)
        run = {"label": label, "tree": tree, "rc": rc, "card": card, "log": log,
               "probe_rc": p.returncode}
        if p.returncode == 0:
            run.update(json.loads(p.stdout.strip().splitlines()[-1]))
        else:
            run["probe_error"] = p.stderr[-2000:]
        runs.append(run)
    keys = [k for k in runs[0] if k.endswith("sha256")]
    digests = {k: {r.get(k) for r in runs} for k in keys}
    printed = [printed_sha256(r["log"]) for r in runs]
    for k in set().union(*printed):
        values = {p[k] for p in printed if k in p}
        digests[f"log:{k}"] = values
    differing = sorted(k for k, v in digests.items() if len(v) != 1 or None in v)
    identical = bool(keys) and not differing
    for r, p in zip(runs, printed):
        r["printed_sha256"] = p
    ok = identical and all(r["rc"] == 0 and r["probe_rc"] == 0 for r in runs)
    print(json.dumps({"ok": ok, "streams_identical": identical,
                      "sha256_compared": sorted(digests), "sha256_differing": differing,
                      "runs": runs}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:] == ["--probe"]:
        print(json.dumps(probe()), flush=True)
    elif len(sys.argv) == 2 and not sys.argv[1].startswith("-"):
        sys.exit(main(sys.argv[1]))
    else:
        sys.exit(__doc__)
