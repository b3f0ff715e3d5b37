"""Launcher of the CUDA dense stream compaction (csrc/compact_stream.cu), the
port of flac_tpu/encode/packer.py::compact_stream_words.

`compact_stream` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`encode.packer.compact_stream_words_kernel`, which picks by the tensors'
device. `launches` counts the launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("compact_stream")
    fn = lib.flac_compact_stream
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 2 + [ctypes.c_void_p]
    return lib


def compact_stream(words: torch.Tensor, total_bits: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(stream [B*W] int32 (uint32 bits), total int64 scalar) of the frames
    in `words` [B, W] int32 with `total_bits` [B] int32, both on one CUDA
    device; the results stay there. Every frame must be byte-aligned and
    hold at least 4 bytes, at most 4*W (FLAC frames hold at least 10)."""
    global launches
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"compact_stream runs on CUDA tensors, got {dev}")
    if words.dim() != 2 or words.dtype != torch.int32 or words.shape[0] < 1:
        raise ValueError(f"compact_stream: words must be int32 [B, W] with B >= 1, "
                         f"got {words.dtype} {tuple(words.shape)}")
    B, W = words.shape
    if (total_bits.device != dev or total_bits.dtype != torch.int32
            or tuple(total_bits.shape) != (B,)):
        raise ValueError(f"compact_stream: total_bits must be int32 ({B},) on {dev}, "
                         f"got {total_bits.dtype} {tuple(total_bits.shape)} on "
                         f"{total_bits.device}")
    if B * W >= 2 ** 31:
        raise ValueError(f"compact_stream: {B} x {W} words is too large")
    words, total_bits = words.contiguous(), total_bits.contiguous()
    out = torch.empty(B * W, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_compact_stream(words.data_ptr(), total_bits.data_ptr(),
                                     out.data_ptr(), total.data_ptr(), B, W, stream)
    if rc != 0:
        raise RuntimeError(f"compact_stream kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, total
