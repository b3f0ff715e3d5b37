"""Percent of the bytes bound that the subframe scans (subframe_scan_kernel,
wide_scan_kernel) reach in the traced window: the stream bytes of the
frames decoded on the card plus one int32 residual a sample written, at
the card's peak bandwidth, over the kernels' time by name in the trace."""

from cardbench.metrics import _roofline

COUNTERS = {"scan_launches": ["flac_tpu_torch.kernels.residual_scan:launches",
                              "flac_tpu_torch.kernels.residual_scan:wide_launches"]}


def read(rec):
    t = rec["traced"]
    return _roofline.share(rec, ("subframe_scan_kernel", "wide_scan_kernel"),
                           _roofline.scan_bytes(t["scan_bytes"], t["scan_samples"],
                                                rec["channels"]),
                           "scan_launches", "scan_roofline.decode")
