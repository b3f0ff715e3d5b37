"""Milliseconds the device was busy (the union of its events under the
profiler) in the traced window, a batch encoded there (EncodeStats.
batches, the final partial frames included)."""


def read(rec):
    batches = rec["traced"]["batches"]
    if not batches or not rec["trace"]["device_events"]:
        return None
    return 1e3 * rec["trace"]["busy_s"] / batches
