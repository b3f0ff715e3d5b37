"""Percent of the bytes bound that the subframe scans (subframe_scan_kernel,
wide_scan_kernel) reach in an encode's verify in the traced window: the
compressed bytes of the frames encoded there plus one int32 residual a
sample, scan_roofline.decode's formula, at the card's peak bandwidth, over
the kernels' time by name in the trace."""

from cardbench.metrics import _roofline

COUNTERS = {"scan_launches": ["flac_tpu_torch.kernels.residual_scan:launches",
                              "flac_tpu_torch.kernels.residual_scan:wide_launches"]}


def read(rec):
    t = rec["traced"]
    return _roofline.share(rec, ("subframe_scan_kernel", "wide_scan_kernel"),
                           _roofline.scan_bytes(t["frame_bytes"], t["samples"],
                                                rec["channels"]),
                           "scan_launches", "verify_scan_roofline.encode")
