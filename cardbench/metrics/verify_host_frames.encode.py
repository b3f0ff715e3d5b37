"""Frames verified on the host decoder (those the scan flagged, and each
file's final partial frame), per 1,000 frames verified in the window: the
program's `verify_host_frames` over `verified_frames`."""

from cardbench.metrics import _verify

COUNTERS = _verify.COUNTERS


def read(rec):
    c = rec["window_counters"]
    if not c["verified_frames"]:
        return None
    return 1e3 * c["verify_host_frames"] / c["verified_frames"]
