"""flac_tpu_torch — the PyTorch/CUDA port of flac_tpu.

The same FLAC codec, module for module, with PyTorch in place of JAX and a
kernel written by hand for NVIDIA Hopper (CUDA C++, `csrc/`) wherever
flac_tpu has a Pallas kernel for the TPU. flac_tpu stays the reference each
part is held against; this package never imports it, nor JAX.

Entry points take `device=None`, which means CUDA: they raise when no GPU is
present unless the caller passes `device="cpu"` (see `device.py`).
"""

from flac_tpu_torch.version import __version__  # noqa: F401

__all__ = ["__version__"]
