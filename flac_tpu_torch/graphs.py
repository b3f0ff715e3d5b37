"""The encode step as one CUDA graph a shape: the port's counterpart of the
`jax.jit` that flac_tpu puts around its encode steps
(flac_tpu/encode/frame_encoder.py's `jax.jit(full)` and
`jax.jit(encode_dense)`).

`GraphedStep(fn, name, device)` wraps a step whose inputs are tensors or
numpy arrays and whose outputs are tensors, in tuples and dicts. A graph
replays the kernels of the step's eager run in the same order, on static
copies of its inputs, so its outputs are the eager ones bit for bit
(`torch.compile` would fuse ops and reorder the float32 sums that
dsp/lpc.py keeps in XLA:CPU's order). On a CPU device every call runs
`fn` eagerly. On CUDA, per shape (the shapes and dtypes of all inputs, as
`jax.jit` retraces a new shape):

- call 1 runs `fn` eagerly: it builds the kernels, fills their caches and
  primes the allocator, and a step called once at a shape is never
  captured: a final partial frame's step built for its own length, which
  encode.frame_encoder.encode_tail keeps for the few short lengths that
  the length-generic tail step does not take (that step has one shape for
  every other length, so it captures at the second such tail a process
  encodes);
- call 2 copies the inputs into static device buffers, captures `fn` on
  them into a graph with a private memory pool, and replays it once;
- every later call copies its inputs in and replays.

A replay waits for nothing on the device: each host (numpy or CPU tensor)
input is copied into one of two page-locked staging buffers of its shape,
made at the capture and used in turn, and from there into the static
buffer with a non-blocking copy behind the previous replay on the stream;
a staging buffer is written again only after the event recorded after
its last copy has completed. So a caller may launch the next batch's
replay before it reads the previous batch's outputs. Inputs already on
the device are copied as they are.

Each call returns fresh tensors, one device copy of each output, as
`jax.jit` does, so an output kept on the device is never overwritten by the
next replay. A capture or replay that fails raises `KernelError`, naming the
step and the line where the capture stopped; nothing falls back to eager.

The kernel launchers count at their Python call, which a replay does not
run: a graph records each counter's increase during its capture and adds it
on every later replay, so every count stays one a call. `eager_calls`,
`captures` and `replays` count this process's calls of each kind; `log`
holds a record of each capture (step, shapes, pool bytes, capture time).
At most MAX_GRAPHS graphs live in a process: capturing another releases the
one replayed least recently, and its step captures again at its next call.

Each call is one span of flac_tpu_torch.trace: `step.eager` (every call on
the CPU), `step.capture` or `step.replay`, the last two with a child
`step.copy_in` around the copy of the inputs into the static buffers.
"""

from __future__ import annotations

import collections
import os
import time
import traceback

import numpy as np
import torch

from flac_tpu_torch import trace
from flac_tpu_torch.kernels import KernelError

MAX_GRAPHS = 8

eager_calls = 0
captures = 0
replays = 0
log: list[dict] = []

# (id(step), key) -> step, least recently replayed first
_live: collections.OrderedDict = collections.OrderedDict()


def _counters() -> tuple:
    """(owner, attribute) of every kernel launch counter."""
    from flac_tpu_torch.kernels import (compact_stream, iir_scan, pack_words,
                                        residual_scan, restore_scan)
    return ((pack_words, "launches"), (pack_words, "crc_finish_launches"),
            (pack_words.pack_words_multi, "launches"), (compact_stream, "launches"),
            (residual_scan, "launches"), (residual_scan, "wide_launches"),
            (restore_scan, "launches"), (iir_scan, "launches"))


def _read_counters() -> list[int]:
    return [getattr(owner, attr) for owner, attr in _counters()]


def _set_counters(values) -> None:
    for (owner, attr), v in zip(_counters(), values):
        setattr(owner, attr, v)


def _fresh(obj, memo: dict):
    """A device copy of every tensor in obj (tuples, lists and dicts kept);
    a tensor that appears twice is copied once."""
    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            memo[id(obj)] = obj.clone()
        return memo[id(obj)]
    if isinstance(obj, (tuple, list)):
        return type(obj)(_fresh(o, memo) for o in obj)
    if isinstance(obj, dict):
        return {k: _fresh(v, memo) for k, v in obj.items()}
    return obj


_TORCH_DIR = os.path.dirname(torch.__file__)


def _where(exc: BaseException) -> str:
    """The first exception of exc's chain (the one that stopped the
    capture) and the innermost line outside torch and this module that
    raised it."""
    while exc.__cause__ is not None or exc.__context__ is not None:
        exc = exc.__cause__ or exc.__context__
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH_DIR) and f.filename != __file__]
    at = (f"{frames[-1].filename}:{frames[-1].lineno} ({frames[-1].line})"
          if frames else "?")
    return f"{at}: {type(exc).__name__}: {exc}"


class _Graph:
    """One captured shape: the graph, its static inputs and outputs, the
    launch counters' increase during its capture, and the two sets of
    page-locked staging buffers for its host inputs (None for an input on
    the device), each with the event after its last copy, the set of
    `turn` free for the next replay."""

    __slots__ = ("graph", "inputs", "outputs", "deltas", "staging", "staged", "turn")

    def __init__(self, graph, inputs, outputs, deltas, staging):
        self.graph, self.inputs, self.outputs, self.deltas = graph, inputs, outputs, deltas
        self.staging = staging
        self.staged = (torch.cuda.Event(), torch.cuda.Event())
        self.turn = 0

    def copy_in(self, inputs) -> None:
        """Copy a replay's inputs into the static buffers: each host input
        through the free staging buffer, without waiting for the device."""
        turn, self.turn = self.turn, 1 - self.turn
        done = self.staged[turn]
        done.synchronize()  # the device has read this set's last inputs
        for static, pinned, t in zip(self.inputs, self.staging[turn], inputs):
            if pinned is None:
                static.copy_(t)
            else:
                # numpy's copy runs on this thread alone; torch's CPU copy_
                # of a 2 MB batch took 2.5-8.8 ms beside the encoder's MD5
                # thread on an H100's host, numpy's well under 1 ms
                np.copyto(pinned.numpy(), t.numpy())
                static.copy_(pinned, non_blocking=True)
        done.record(torch.cuda.current_stream(self.inputs[0].device))


class GraphedStep:
    """`fn` run eagerly at a shape's first call, captured at its second and
    replayed from its third on (see the module's docstring)."""

    def __init__(self, fn, name: str, device: str | torch.device):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self._shapes: dict[tuple, _Graph | None] = {}  # None: warmed, not captured

    def __repr__(self) -> str:
        return f"GraphedStep({self.name!r}, {self.device})"

    def __call__(self, *args):
        global eager_calls
        if self.device.type != "cuda":
            with trace.span("step.eager"):
                return self.fn(*args)
        inputs = tuple(torch.as_tensor(a) for a in args)
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        if key not in self._shapes:
            self._shapes[key] = None
            eager_calls += 1
            with trace.span("step.eager"):
                return self.fn(*inputs)
        g = self._shapes[key]
        if g is None:
            with trace.span("step.capture"):
                return self._capture(key, inputs)
        with trace.span("step.replay"):
            return self._replay(key, g, inputs)

    def _capture(self, key, inputs):
        global captures
        while len(_live) >= MAX_GRAPHS:
            (_, k), step = _live.popitem(last=False)
            step._shapes[k] = None
        with torch.cuda.device(self.device):
            static = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                           for t in inputs)
            staging = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                             if t.device.type == "cpu" else None for t in inputs)
                       for _ in range(2)]
            with trace.span("step.copy_in"):
                for s, t in zip(static, inputs):
                    s.copy_(t)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            before = _read_counters()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    outputs = self.fn(*static)
            except Exception as e:
                _set_counters(before)
                raise KernelError(f"{self.name}: CUDA graph capture at shapes "
                                  f"{[s for s, _ in key]} failed at {_where(e)}") from e
            capture_s = time.perf_counter() - t0
            deltas = [a - b for a, b in zip(_read_counters(), before)]
            pool_bytes = torch.cuda.memory_reserved() - reserved
            g = _Graph(graph, static, outputs, deltas, staging)
        self._shapes[key] = g
        _live[(id(self), key)] = self
        captures += 1
        log.append({"step": self.name, "shapes": [list(s) for s, _ in key],
                    "pool_bytes": pool_bytes, "capture_ms": capture_s * 1e3})
        return self._run(g)

    def _replay(self, key, g: _Graph, inputs):
        global replays
        with trace.span("step.copy_in"):
            g.copy_in(inputs)
        out = self._run(g)
        _set_counters([v + d for v, d in zip(_read_counters(), g.deltas)])
        _live.move_to_end((id(self), key))
        replays += 1
        return out

    def _run(self, g: _Graph):
        try:
            g.graph.replay()
        except Exception as e:
            raise KernelError(f"{self.name}: CUDA graph replay failed: {e}") from e
        return _fresh(g.outputs, {})

    def release(self) -> None:
        """Drop this step's graphs and their memory pools; each shape
        captures again at its next call."""
        for key, g in self._shapes.items():
            if g is not None:
                self._shapes[key] = None
                _live.pop((id(self), key), None)
