"""Launcher of the CUDA dense stream compaction (csrc/compact_stream.cu), the
port of flac_tpu/encode/packer.py::compact_stream_words.

`compact_stream` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`encode.packer.compact_stream_words_kernel`, which picks by the tensors'
device. `launches` counts the launches of this process. `grid_blocks`
gives the number of blocks a launch takes; `launch_probe` launches the
source's empty kernel on such a grid, to time the least a launch costs,
and is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build
from flac_tpu_torch.kernels._build import KernelError

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("compact_stream")
    fn = lib.flac_compact_stream
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 2 + [ctypes.c_void_p]
        lib.flac_compact_stream_max_frames.restype = ctypes.c_int
        lib.flac_compact_stream_max_frames.argtypes = []
        lib.flac_compact_stream_blocks.restype = ctypes.c_int
        lib.flac_compact_stream_blocks.argtypes = [ctypes.c_int32] * 2
        lib.flac_compact_launch_probe.restype = ctypes.c_int
        lib.flac_compact_launch_probe.argtypes = [ctypes.c_int32] * 2 + [ctypes.c_void_p]
    return lib


def grid_blocks(B: int, W: int) -> int:
    """The number of blocks the kernel launches for B frames of W words."""
    return _lib().flac_compact_stream_blocks(B, W)


def launch_probe(blocks: int, pdl: bool, device: str | torch.device = "cuda") -> None:
    """Launch the source's empty kernel (griddepcontrol.wait alone) on
    `blocks` blocks of the compaction's width, with programmatic dependent
    launch when `pdl`, on the device's current stream."""
    dev = torch.device(device)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_compact_launch_probe(blocks, int(pdl), stream)
    if rc != 0:
        raise KernelError(f"compaction launch probe failed: CUDA error {rc}")


def compact_stream(words: torch.Tensor, total_bits: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(stream [B*W] int32 (uint32 bits), total int64 scalar) of the frames
    in `words` [B, W] int32 with `total_bits` [B] int32, both on one CUDA
    device; the results stay there. Every frame must be byte-aligned and
    hold at least 4 bytes, at most 4*W (FLAC frames hold at least 10). B is
    at most what the kernel's shared memory holds (16,384 frames). The
    launch may overlap the tail of the kernel before it on the stream
    (programmatic dependent launch); the kernel waits for that kernel's
    writes before it reads or writes anything."""
    global launches
    dev = words.device
    if dev.type != "cuda":
        raise KernelError(f"compact_stream runs on CUDA tensors, got {dev}")
    if words.dim() != 2 or words.dtype != torch.int32 or words.shape[0] < 1:
        raise KernelError(f"compact_stream: words must be int32 [B, W] with B >= 1, "
                          f"got {words.dtype} {tuple(words.shape)}")
    B, W = words.shape
    if (total_bits.device != dev or total_bits.dtype != torch.int32
            or tuple(total_bits.shape) != (B,)):
        raise KernelError(f"compact_stream: total_bits must be int32 ({B},) on {dev}, "
                          f"got {total_bits.dtype} {tuple(total_bits.shape)} on "
                          f"{total_bits.device}")
    if B * W >= 2 ** 31 or W >= 2 ** 28:
        raise KernelError(f"compact_stream: {B} x {W} words is too large")
    lib = _lib()
    if B > lib.flac_compact_stream_max_frames():
        raise KernelError(f"compact_stream: {B} frames is more than the kernel's shared "
                          f"memory holds ({lib.flac_compact_stream_max_frames()})")
    words, total_bits = words.contiguous(), total_bits.contiguous()
    # a fresh allocation: 16-byte aligned, as the kernel's uint4 stores need
    out = torch.empty(B * W, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_compact_stream(words.data_ptr(), total_bits.data_ptr(),
                                     out.data_ptr(), total.data_ptr(), B, W, stream)
    if rc != 0:
        raise KernelError(f"compact_stream kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, total
