"""One run of one cell: set-up, the timed window, the check, the metrics
and the result line.

Everything that belongs to one configuration, one traffic mix, one loop,
one source of files or one metric is found by its name, beside this
module: a configuration's file is its `BENCHMARK.json` entry's `file`, a
mix is `mixes/<traffic>.json`, the mix names its loop (`loops/<loop>.py`)
and its files (`files/<files>.py`), and a metric is `metrics/<name>.py`.
A reader names the program's counters it reads (its COUNTERS), which the
window reads at its start and close.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "flac_tpu")


class SpecError(Exception):
    """A cell, configuration, mix, loop, source or metric that the files do
    not define."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix_name: str
    mix: dict
    end_to_end: list
    per_layer: list
    loop: object = None
    files: object = None
    readers: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)


def _json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing {path}") from e


def load_part(bench: str, kind: str, name: str):
    """<bench>/<kind>/<name>.py, loaded by its path."""
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"no {kind} module {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(bench: str, name: str):
    """metrics/<name>.py: its read(record) gives the value, or None where
    the run has nothing for it to read; its COUNTERS, if any, name the
    program's counters it reads."""
    return load_part(bench, "metrics", name)


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    bench = os.path.join(root, "cardbench")
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    entry = next((c for c in spec["configs"] if c["name"] == work["config"]), None)
    if entry is None:
        raise SpecError(f"no configuration {work['config']!r} in BENCHMARK.json")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without `workloads` goes with the metric it moves
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    mix = _json(os.path.join(bench, "mixes", work["traffic"] + ".json"))
    cell = Cell(name=name, chips=work["chips"],
                config=_json(os.path.join(root, entry["file"])), mix_name=work["traffic"],
                mix=mix, end_to_end=e2e, per_layer=per_layer,
                loop=load_part(bench, "loops", mix["loop"]),
                files=load_part(bench, "files", mix["files"]))
    for m in e2e + per_layer:
        reader = cell.readers[m["name"]] = load_reader(bench, m["name"])
        cell.counters.update(getattr(reader, "COUNTERS", {}))
    return cell


def program_counters(spec: dict):
    """A function that reads the program's counters named in `spec`, each
    the sum of its attributes ("module:attribute.path")."""
    paths = {}
    for name, attrs in spec.items():
        for attr in attrs:
            module, _, path = attr.partition(":")
            if module.split(".")[0] in FORBIDDEN:
                raise SpecError(f"counter {name}: {module} may not be loaded")
            obj, *chain = [importlib.import_module(module)] + path.split(".")
            for a in chain[:-1]:
                obj = getattr(obj, a)
            paths.setdefault(name, []).append((obj, chain[-1]))

    def read() -> dict:
        return {name: sum(getattr(o, a) for o, a in attrs) for name, attrs in paths.items()}

    return read


@dataclass
class Conf:
    """A configuration file as the run uses it."""

    sample_rate: int
    bits: int
    channels: int
    level: int
    blocksize: int
    verify: bool
    album_seconds: float
    tracks: int
    album_tracks: int
    track_seconds: tuple
    encoder: object = None

    @classmethod
    def read(cls, d: dict) -> "Conf":
        return cls(sample_rate=d["sample_rate"], bits=d["bits_per_sample"],
                   channels=d["channels"], level=d["level"], blocksize=d["blocksize"],
                   verify=d["verify"], album_seconds=d["album_seconds"], tracks=d["tracks"],
                   album_tracks=d["album_tracks"], track_seconds=tuple(d["track_seconds"]))


@dataclass
class Run:
    """What a loop works with: the configuration, the mix, the seed, the
    device, the source's files, the program's chunk, the control, and what
    the loop keeps from one of its steps to the next."""

    conf: Conf
    mix: dict
    seed: int
    device: object
    source: object
    step: int
    control: str | None
    state: dict = field(default_factory=dict)


# -- one run ---------------------------------------------------------------


def card_power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def run(root: str, cell: Cell, seed: int, seconds: float, trace: bool, device,
        control: str | None = None, t_start: float | None = None,
        dump_trace: str | None = None, log=print) -> dict:
    """One run of `cell` on `device`; the result line as a dict, and the
    numbers compared under "checks"."""
    import torch

    from cardbench import check, loops
    from cardbench.trace import Tracer, breakdown, dump, reduce_events
    from flac_tpu_torch.encode.frame_encoder import EncoderConfig

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    counters = program_counters(cell.counters)
    conf = Conf.read(cell.config)
    conf.encoder = EncoderConfig.from_level(conf.level, conf.channels, conf.bits,
                                            conf.sample_rate, blocksize=conf.blocksize)
    # set-up: the inputs on the device from the seed, then the loop's own
    # (the warm-up of the cell's own full-batch shape on a stream of the
    # seed of its own)
    r = Run(conf=conf, mix=cell.mix, seed=seed, device=device,
            source=cell.files.make(torch, conf, cell.mix, seed, device),
            step=max(conf.blocksize * 64, 1 << 20),  # encode_file's chunk
            control=control)
    cell.loop.setup(r)
    gc.collect()
    if on_card:  # the peak from here on: the window's, not the PCM's making
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    window = loops.Window(seconds, sync, Tracer(torch, device) if trace else None)
    setup_s = time.perf_counter() - t_start
    window.start(counters)
    cell.loop.drive(r, window)
    sync()
    if window.open:  # the loop ran out of work before the time was up
        raise RuntimeError("the window closed without a unit boundary")
    memory_peak = torch.cuda.max_memory_reserved(device) if on_card else 0

    rec = dict(loop=cell.mix["loop"], setup_s=setup_s, window_s=window.elapsed,
               samples=window.totals["samples"], bytes=window.totals["bytes"],
               pcm_bytes=window.totals["samples"] * conf.channels * ((conf.bits + 7) // 8),
               units=window.totals["units"], host_frames=window.totals["host_frames"],
               channels=conf.channels, card=None)
    attempted, failed = cell.loop.result(r, rec)
    if trace:
        events = window.tracer.events()
        rec["trace"] = reduce_events(events)
        rec["traced"] = dict(window.traced)
        c0, c1 = window.trace_counters
        c1 = c1 or counters()
        rec["trace_counters"] = {k: c1[k] - c0[k] for k in c0}
        rec["window_counters"] = {k: window.counters1[k] - window.counters0[k]
                                  for k in window.counters0}
        rec["card"] = card_power_limit() if on_card else None
        rec["device_name"] = torch.cuda.get_device_name(device) if on_card else None
        if dump_trace:
            dump(events, {k: rec[k] for k in ("traced", "trace_counters", "window_counters",
                                               "card", "device_name")}, dump_trace)
        del events
        rec["note"] = lambda d: log(json.dumps(d))

    # the program's state goes before the reference runs on the device
    window.tracer = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.loop.check(r)
    correct, checks = check.verdict(numbers)
    log(json.dumps({"setup_s": setup_s, "window_s": window.elapsed,
                    "check_s": time.perf_counter() - t_check}))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = breakdown(rec["trace"])
    result["checks"] = {**checks, "files_checked": {"value": numbers["files_checked"],
                                                    "least": 1}}
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("lsb",), default=None,
                    help="feed the program the PCM with its lowest bit cleared "
                         "(the check's control: must come out not correct)")
    ap.add_argument("--dump-trace", default=None,
                    help="write the traced window's events to this file")
    args = ap.parse_args(argv)
    try:
        cell = load_cell(ROOT, args.workload)
    except SpecError as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache = os.path.join(ROOT, ".cardbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    result = run(ROOT, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 control=args.control, t_start=t_start, dump_trace=args.dump_trace)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"least {c['least']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
