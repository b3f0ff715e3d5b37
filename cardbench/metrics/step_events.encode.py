"""Device events (kernels, copies, fills) in the traced window, a batch
encoded there, counted as step_busy_ms.encode counts batches."""


def read(rec):
    batches = rec["traced"]["batches"]
    if not batches or not rec["trace"]["device_events"]:
        return None
    return rec["trace"]["device_events"] / batches
