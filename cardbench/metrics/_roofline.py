"""Peaks of the cards and the bytes each kernel's stage has to move.

A stage's bytes count only what any implementation of it must move,
worked out from the call's own audio and stream sizes, never from the
program's layouts: pack writes the batch's compressed frames; a subframe
scan reads the stream's frames and writes one int32 residual a sample.
"""

from __future__ import annotations

# published peaks, at the card's full power limit (NVIDIA's data sheet,
# SXM part): bytes a second of HBM
HBM_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def pack_bytes(frame_bytes: int) -> int:
    return frame_bytes


def scan_bytes(stream_bytes: int, samples: int, channels: int) -> int:
    return stream_bytes + 4 * samples * channels


def kernel_seconds(kernels: dict, names: tuple) -> tuple[int, float]:
    """(events, seconds) of the device events whose name holds any of
    `names`."""
    n, s = 0, 0.0
    for k, (count, secs) in kernels.items():
        if any(name in k for name in names):
            n, s = n + count, s + secs
    return n, s


def share(rec: dict, names: tuple, nbytes: int, counter: str, metric: str):
    """Percent of the bytes bound that the named kernels reach in the
    traced window, or None where the trace saw none of them or the card
    has no peak here. Notes the events seen beside the launch counter's
    count over the same window, and the card's power limit."""
    events, secs = kernel_seconds(rec["trace"]["kernels"], names)
    peak = HBM_BYTES_S.get(rec.get("device_name"))
    rec["note"]({"reader": metric, "kernel_events_seen": events,
                 "launch_counter": rec["trace_counters"][counter],
                 "bytes": nbytes, "kernel_s": secs, "peak_bytes_s": peak,
                 "card": rec.get("card")})
    if not events or not secs or peak is None:
        return None
    return 100.0 * nbytes / peak / secs
