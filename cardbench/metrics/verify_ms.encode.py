"""Host-clock milliseconds inside the encoder's verify (decodes on the
card and on the host, the comparisons), in the traced window, a batch
encoded there (EncodeStats.batches, the final partial frames included):
the program's `verify_ns`."""

from cardbench.metrics import _verify

COUNTERS = _verify.COUNTERS


def read(rec):
    c, batches = rec["trace_counters"], rec["traced"]["batches"]
    if not c["verified_frames"] or not batches:
        return None
    return c["verify_ns"] / 1e6 / batches
