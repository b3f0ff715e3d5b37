"""The closed loops that drive the program, one file after another, and the
window that times them.

A mix names its loop: `loops/<loop>.py`, found by that name, holds
setup(run) (the warm-up and whatever the loop needs before the window),
drive(run, window) (the timed loop), result(run, rec) (its keys of the
record, and the calls attempted and failed) and check(run) (the numbers
the check compares). This module holds the window and what loops share.

The window counts work by unit: one `StreamEncoder.process()` chunk (the
1 Mi-sample step that `encode_file` feeds), one `finish()`, or one
`decode_bytes_device` call. It opens after set-up and closes at the first
unit boundary at or after `seconds`; every rate is the work of the units
completed by then over the time to that boundary. A file cut by the close
is finished after it, so that its stream can be checked. In a traced run
the profiler covers the window's first units, up to TRACE_SECONDS.
"""

from __future__ import annotations

import contextlib
import io
import time

TRACE_SECONDS = 4.0


class Window:
    """The timed window and its totals, kept at unit boundaries."""

    def __init__(self, seconds: float, sync, tracer=None):
        self.seconds = seconds
        self.sync = sync
        self.tracer = tracer
        self.tracing = False
        self.open = True
        self.t0 = self.t_close = None
        self.totals = dict(samples=0, bytes=0, batches=0, units=0, host_frames=0)
        self.traced = dict(samples=0, bytes=0, batches=0, units=0, frame_bytes=0,
                           scan_bytes=0, scan_samples=0)
        self.counters0 = self.counters1 = None
        self.trace_counters = [None, None]

    def start(self, counters) -> None:
        self.sync()
        self._counters = counters
        if self.tracer is not None:
            self.tracer.start()
            self.tracing = True
        self.counters0 = counters()
        self.trace_counters[0] = self.counters0
        self.t0 = time.perf_counter()

    def unit(self, name: str):
        """The span of one unit: the tracer's mark while tracing."""
        return self.tracer.unit(name) if self.tracing else contextlib.nullcontext()

    def add(self, **work) -> None:
        """Count one unit's work; close the window at this boundary once
        its time is up (and stop the trace at its own limit)."""
        if not self.open:
            return
        for k, v in work.items():
            if k in self.totals:
                self.totals[k] += v
            if self.tracing and k in self.traced:
                self.traced[k] += v
        self.totals["units"] += 1
        now = time.perf_counter()
        if self.tracing:
            self.traced["units"] += 1
            if now - self.t0 >= min(TRACE_SECONDS, self.seconds):
                self.tracer.stop()
                self.tracing = False
                self.trace_counters[1] = self._counters()
                now = time.perf_counter()
        if now - self.t0 >= self.seconds:
            self.sync()
            self.t_close = time.perf_counter()
            self.open = False
            self.counters1 = self._counters()

    @property
    def elapsed(self) -> float:
        return self.t_close - self.t0


def run_unit(window: Window, name: str, enc, sink, call, header: bool = False) -> None:
    """One encoder call as a unit, its samples, bytes, batches and frame
    bytes counted by the encoder's stats and its sink."""
    st = enc.stats
    before = (st.samples, 0 if header else sink.tell(), st.batches, st.bytes_written)
    with window.unit(name):
        call()
    window.add(samples=st.samples - before[0], bytes=sink.tell() - before[1],
               batches=st.batches - before[2], frame_bytes=st.bytes_written - before[3])


def encode_bytes(run, pcm) -> bytes:
    """One stream of the program's encoder, fed as encode_file feeds it."""
    from flac_tpu_torch.encode.encoder import StreamEncoder
    sink = io.BytesIO()
    enc = StreamEncoder(run.conf.encoder, sink, total_samples_estimate=len(pcm),
                        verify=run.conf.verify, device=run.device)
    for s in range(0, len(pcm), run.step):
        enc.process(pcm[s:s + run.step])
    enc.finish()
    return sink.getvalue()


def warm_pcm(run, frames: int):
    """The warm-up input: `frames` full frames from a stream of the seed of
    its own, never the timed files'."""
    from cardbench import traffic
    c = run.conf
    return traffic.to_host(traffic.music([frames * c.blocksize], c.sample_rate, c.bits,
                                         run.seed, "warmup", run.device))
