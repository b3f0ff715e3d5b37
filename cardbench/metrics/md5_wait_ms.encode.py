"""Host-clock milliseconds the encoder's main thread waited for its MD5
worker (the program's `md5_wait_ns`), in the traced window, a batch
encoded there (EncodeStats.batches, the final partial frames included);
nothing where no update ran on a worker there (`md5_updates`)."""

from cardbench.metrics import _md5

COUNTERS = _md5.COUNTERS


def read(rec):
    c, batches = rec["trace_counters"], rec["traced"]["batches"]
    if not c["md5_updates"] or not batches:
        return None
    return c["md5_wait_ns"] / 1e6 / batches
