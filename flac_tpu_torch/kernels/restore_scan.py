"""Launcher of the CUDA fixed/LPC restore (csrc/restore_scan.cu), the port of
flac_tpu/decode/frame_decoder.py::_restore_scan.

`restore_scan` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`decode.frame_decoder.restore_scan_kernel`, which picks by the tensors'
device. `launches` counts the launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("restore_scan")
    fn = lib.flac_restore_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
    return lib


def restore_scan(res, coeffs, order, shift, warm, is_coded, T, maxord):
    """x [B, T] int64 of the restore recurrence; the arguments as
    frame_decoder.restore_scan takes them (res [B, T] int32 or int64, the
    narrow or the wide scan's; coeffs, warm [B, maxord] int64; order, shift
    [B] int64; is_coded [B] bool), all on one CUDA device. The rows are
    independent: the frame decoder stacks every channel's into one launch."""
    global launches
    dev = res.device
    if dev.type != "cuda":
        raise ValueError(f"restore_scan runs on CUDA tensors, got {dev}")
    if res.dim() != 2:
        raise ValueError(f"restore_scan: res must be [B, T], got {tuple(res.shape)}")
    B = res.shape[0]
    if tuple(res.shape) != (B, T) or not 0 < T < 2 ** 31 or maxord < 0:
        raise ValueError(f"restore_scan: bad sizes {tuple(res.shape)} T={T} "
                         f"maxord={maxord}")
    res64 = res.dtype == torch.int64
    args = []
    for name, t, dtype, shape in (("res", res, torch.int64 if res64 else torch.int32,
                                   (B, T)),
                                  ("coeffs", coeffs, torch.int64, (B, maxord)),
                                  ("order", order, torch.int64, (B,)),
                                  ("shift", shift, torch.int64, (B,)),
                                  ("warm", warm, torch.int64, (B, maxord)),
                                  ("is_coded", is_coded, torch.bool, (B,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"restore_scan: {name} must be {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    x = torch.empty((B, T), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_restore_scan(*[a.data_ptr() for a in args], x.data_ptr(),
                                   B, T, maxord, int(res64), stream)
    if rc != 0:
        raise RuntimeError(f"restore_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return x
