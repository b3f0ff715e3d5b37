"""Percent of the encode step's calls in the window that replayed a CUDA
graph, of all its calls (eager, capture, replay): graphs.py's counters."""

COUNTERS = {k: [f"flac_tpu_torch.graphs:{k}"] for k in ("eager_calls", "captures", "replays")}


def read(rec):
    c = rec["window_counters"]
    calls = c["eager_calls"] + c["captures"] + c["replays"]
    return 100.0 * c["replays"] / calls if calls else None
