"""An in-memory span recorder for the port's host stages.

Spans mark the layer boundaries of the stream drivers (encode/encoder.py,
decode/stream.py), the frame encoder's builds and the graphed step
(graphs.py), so that a trace of the device can be read against what the
host was doing. The recorder is off by default; while it is off `span()`
returns one shared no-op context manager and records, allocates and times
nothing. An operator turns it on around the work to be traced:

    from flac_tpu_torch import trace
    trace.start()
    ...                      # encode, decode
    spans = trace.stop()     # list of span tuples, in the order they ended

Each span is a tuple (name, span_id, parent_id, stream_id, thread_id,
start_ns, end_ns):

- span_id counts from 1 in the process; parent_id is the innermost span
  open on the same thread when it began (0: none), or the span that
  handed the work to a worker thread (`current()` passed as `parent=`);
- stream_id names the request: one StreamEncoder from its construction to
  finish(), or one decode_bytes_device call (0: no request);
- thread_id is `threading.get_ident()`;
- start_ns and end_ns are `now_ns()`: nanoseconds since the Unix epoch,
  the base of torch.profiler's device timestamps.

The list holds at most MAX_SPANS spans; `dropped` counts those past it.
No span is opened inside a function that a CUDA graph captures (it would
record at the capture and never at a replay), nor inside a per-frame loop.
"""

from __future__ import annotations

import itertools
import threading
import time

MAX_SPANS = 1_000_000

now_ns = time.time_ns

_on = False
_spans: list = []
dropped = 0
_span_ids = itertools.count(1)
_stream_ids = itertools.count(1)
_local = threading.local()
_drop_lock = threading.Lock()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "sid", "parent", "stream", "t0")

    def __init__(self, name: str, stream: int | None, parent: tuple | None):
        self.name = name
        self.stream = stream
        self.parent = parent

    def __enter__(self):
        stack = _stack()
        parent = self.parent or (stack[-1] if stack else (0, 0))
        self.parent = parent[0]
        if self.stream is None:
            self.stream = parent[1]
        self.sid = next(_span_ids)
        stack.append((self.sid, self.stream))
        self.t0 = now_ns()
        return self

    def __exit__(self, *exc):
        global dropped
        t1 = now_ns()
        _local.stack.pop()
        if not _on:  # a span still open at stop() is left out
            return False
        if len(_spans) < MAX_SPANS:
            _spans.append((self.name, self.sid, self.parent, self.stream,
                           threading.get_ident(), self.t0, t1))
        else:
            with _drop_lock:
                dropped += 1
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, stream: int | None = None, parent: tuple | None = None):
    """A context manager that records one span named `name` while the
    recorder is on. `stream` sets the request's id (otherwise the parent's
    is kept); `parent`, a `current()` taken on another thread, makes that
    span the cause of work run on this one."""
    if not _on:
        return _NO_SPAN
    return _Span(name, stream, parent)


def current() -> tuple | None:
    """(span_id, stream_id) of this thread's innermost open span, to pass as
    `span(..., parent=)` to work handed to another thread; None while the
    recorder is off or no span is open."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def new_stream() -> int:
    """A fresh request id."""
    return next(_stream_ids)


def start() -> None:
    """Turn the recorder on with an empty list."""
    global _on, _spans, dropped
    _spans, dropped = [], 0
    _on = True


def stop() -> list:
    """Turn the recorder off and return the spans it kept."""
    global _on, _spans
    _on = False
    out, _spans = _spans, []
    return out
