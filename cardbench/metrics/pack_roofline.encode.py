"""Percent of the bytes bound that pack_frames_kernel reaches in the
traced window: the compressed bytes of the frames encoded there, at the
card's peak bandwidth, over the kernel's time by name in the trace."""

from cardbench.metrics import _roofline

COUNTERS = {"pack_launches": ["flac_tpu_torch.kernels.pack_words:launches",
                              "flac_tpu_torch.kernels.pack_words:pack_words_multi.launches"]}


def read(rec):
    return _roofline.share(rec, ("pack_frames_kernel",),
                           _roofline.pack_bytes(rec["traced"]["frame_bytes"]),
                           "pack_launches", "pack_roofline.encode")
