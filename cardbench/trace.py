"""The traced window: `torch.profiler` on the host and the device, and the
reduction of its events to what the per-layer readers take.

An event is a tuple (name, kind, start_ns, end_ns), where kind is
"device" (a kernel, copy or fill on the card) or "unit" (one of the
harness's spans: `cardbench.<unit>` around each call into the program, and
the traced window). `reduce_events` turns a list of them into the record:
the device's busy time (the union of the device events), its events and
time by kernel name, and the idle time by the unit the host was in. Both
the profiler's events and a recorded fixture go through it.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import time

import numpy as np

UNIT_PREFIX = "cardbench."
WINDOW = "cardbench.traced_window"


def _busy_spans(spans: np.ndarray) -> np.ndarray:
    """The union of the spans as disjoint (start, end) spans, sorted."""
    out = []
    for start, end in spans[np.argsort(spans[:, 0], kind="stable")] if len(spans) else ():
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return np.asarray(out, np.int64).reshape(-1, 2)


def _stab(spans: np.ndarray, names: list, points: np.ndarray, default: str) -> list:
    """The name of the span (disjoint, sorted) that holds each point."""
    if not len(spans):
        return [default] * len(points)
    i = np.searchsorted(spans[:, 0], points, side="right") - 1
    inside = (i >= 0) & (points < spans[np.maximum(i, 0), 1])
    return [names[j] if ok else default for j, ok in zip(i, inside)]


def reduce_events(events: list) -> dict:
    """The record of one traced window (see the module's docstring)."""
    window = [e for e in events if e[1] == "unit" and e[0] == WINDOW]
    if not window:
        raise ValueError("the trace holds no traced window")
    w0, w1 = window[0][2], window[0][3]
    dev = [e for e in events if e[1] == "device" and e[3] > w0 and e[2] < w1]
    spans = np.asarray([(max(e[2], w0), min(e[3], w1)) for e in dev], np.int64).reshape(-1, 2)
    kernels: dict = {}
    for e in dev:
        count, secs = kernels.get(e[0], (0, 0.0))
        kernels[e[0]] = (count + 1, secs + (e[3] - e[2]) / 1e9)
    # idle gaps, each named by the harness's unit that holds its midpoint
    busy = _busy_spans(spans)
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    units = sorted((e for e in events if e[1] == "unit" and e[0] != WINDOW), key=lambda e: e[2])
    unit_spans = np.asarray([(e[2], e[3]) for e in units], np.int64).reshape(-1, 2)
    names = _stab(unit_spans, [e[0][len(UNIT_PREFIX):] for e in units],
                  (gaps[:, 0] + gaps[:, 1]) // 2, "harness")
    idle: dict = {}
    for (g0, g1), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
            "device_events": len(dev), "kernels": kernels, "idle": idle}


def idle_percent(rec: dict):
    """Percent of the traced window in which no event ran on the device, or
    None where the trace holds no device event."""
    if not rec["device_events"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time, and the ten largest
    shares of idle time by what the host was doing."""
    ops = sorted(((k, v[1]) for k, v in rec["kernels"].items()), key=lambda kv: -kv[1])
    idle = sorted(rec["idle"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in idle[:10]]}


class Tracer:
    """torch.profiler over the traced window, the device's events only (a
    host trace slows the host that the idle share is about), and the
    harness's own spans on the same clock (the profiler's nanoseconds
    since the epoch): `unit(name)` marks one call into the program;
    `events()` gives the window's events as tuples."""

    def __init__(self, torch, device):
        self.torch = torch
        self.on_card = device.type == "cuda"
        self._prof = None
        self._spans: list = []
        self._t0 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if self.on_card else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize()
        self._spans.append((WINDOW, "unit", self._t0, time.time_ns()))
        self._prof.stop()

    @contextlib.contextmanager
    def unit(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((UNIT_PREFIX + name, "unit", t0, time.time_ns()))

    def events(self) -> list:
        device_type = self.torch.autograd.DeviceType
        out = list(self._spans)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != device_type.CUDA or e.is_user_annotation():
                continue
            start = e.start_ns()
            out.append((e.name(), "device", start, start + e.duration_ns()))
        return out


def dump(events: list, meta: dict, path: str) -> None:
    """Write a traced window's events and the counts read beside them as
    gzipped JSON lines (a fixture for the readers' tests): a first line of
    the counts, the names and the window's start; then one line an event,
    [name index, kind, start, end], in ns from the window's start."""
    w0 = next(e for e in events if e[0] == WINDOW)[2]
    names = sorted({e[0] for e in events})
    index = {n: i for i, n in enumerate(names)}
    with gzip.open(path, "wt") as f:
        f.write(json.dumps(dict(meta, names=names)) + "\n")
        for e in events:
            f.write(json.dumps([index[e[0]], e[1], e[2] - w0, e[3] - w0]) + "\n")


def load(path: str) -> tuple[list, dict]:
    """(events, counts) of a file that dump wrote."""
    with gzip.open(path, "rt") as f:
        meta = json.loads(f.readline())
        names = meta.pop("names")
        return [(names[i], kind, a, b) for i, kind, a, b in map(json.loads, f)], meta
