"""Percent of the bytes bound that equal_loudness_kernel reaches in the
traced window: the filter's bytes (metrics/_iir.py) for the calls made
there, at the card's peak bandwidth, over the kernel's time by name in the
trace. The filter is a recurrence, so its latency, not its bytes, bounds
it: the share reads far under 1%."""

from cardbench.metrics import _iir, _roofline

COUNTERS = {"iir_launches": ["flac_tpu_torch.kernels.iir_scan:launches"]}


def read(rec):
    t, per_call = rec["traced"], rec["replaygain_windows_per_call"]
    if not t["units"] or not t["samples"]:
        return None
    sample_bytes = rec["pcm_bytes"] // (rec["samples"] * rec["channels"])
    return _roofline.share(rec, ("equal_loudness_kernel",),
                           _iir.filter_bytes(t["samples"], t["units"] * per_call,
                                             rec["channels"], sample_bytes),
                           "iir_launches", "iir_roofline.cli")
