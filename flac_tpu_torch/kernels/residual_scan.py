"""Launcher of the CUDA residual/verbatim scan (csrc/residual_scan.cu), the
port of flac_tpu/decode/frame_decoder.py::_narrow_residual_scan.

`residual_scan` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`decode.frame_decoder.narrow_residual_scan_kernel`, which picks by the
tensors' device. `launches` counts the launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build

launches = 0

# the per-frame inputs, in the kernel's argument order, with their dtypes
_FRAME_ARGS = (("pos", torch.int64), ("is_coded", torch.bool),
               ("is_verb", torch.bool), ("ebps", torch.int64),
               ("order", torch.int64), ("plen", torch.int64),
               ("pesc", torch.int64), ("ps", torch.int64))


def _lib() -> ctypes.CDLL:
    lib = _build.load("residual_scan")
    fn = lib.flac_residual_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64]
                       + [ctypes.c_void_p] * len(_FRAME_ARGS)
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p])
    return lib


def residual_scan(words, pos, T, is_coded, is_verb, ebps, order, plen, pesc, ps):
    """(res [B, T] int32, pos [B] int64, ovf [B] bool) of one subframe of
    each of B frames; the arguments as frame_decoder.narrow_residual_scan
    takes them, all on one CUDA device (per-frame integers are converted to
    the kernel's types here)."""
    global launches
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"residual_scan runs on CUDA tensors, got {dev}")
    if words.dim() != 1 or pos.dim() != 1:
        raise ValueError("residual_scan: words must be [W] and pos [B]")
    B = pos.shape[0]
    if words.device != dev or words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(f"residual_scan: words must be contiguous int32 on {dev}")
    if not 0 < T < 2 ** 31 or B >= 2 ** 31:
        raise ValueError(f"residual_scan: bad sizes B={B} T={T}")
    args = []
    for (name, dtype), t in zip(_FRAME_ARGS, (pos, is_coded, is_verb, ebps, order,
                                              plen, pesc, ps)):
        if t.device != dev or tuple(t.shape) != (B,):
            raise ValueError(f"residual_scan: {name} must be [{B}] on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
        args.append(t.to(dtype).contiguous())
    res = torch.empty((B, T), dtype=torch.int32, device=dev)
    pos_out = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_residual_scan(words.data_ptr(), words.shape[0],
                                    *[a.data_ptr() for a in args],
                                    res.data_ptr(), pos_out.data_ptr(),
                                    ovf.data_ptr(), B, T, stream)
    if rc != 0:
        raise RuntimeError(f"residual_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return res, pos_out, ovf
