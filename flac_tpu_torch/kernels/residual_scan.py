"""Launcher of the CUDA subframe scan (csrc/residual_scan.cu): the
subframe-header parse and the residual/verbatim window scan in one kernel,
the port of flac_tpu/decode/frame_decoder.py's `_decode_subframe` parse with
`_narrow_residual_scan` (the narrow instantiation) or with its wide branch
(the wide one).

`subframe_scan` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`decode.frame_decoder.subframe_scan_kernel`, which picks by the tensors'
device. `launches` counts the narrow kernel's launches of this process,
`wide_launches` the wide kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build

launches = 0
wide_launches = 0

# read_subframe_header's fields, in the kernel's argument order, with their
# dtypes; warm and qlp are [B, maxord], the others [B]
SUBFRAME_FIELDS = (("pos", torch.int64), ("is_const", torch.bool),
                   ("is_verb", torch.bool), ("is_fixed", torch.bool),
                   ("is_lpc", torch.bool), ("is_coded", torch.bool),
                   ("order", torch.int64), ("wasted", torch.int64),
                   ("ebps", torch.int64), ("cval", torch.int64),
                   ("warm", torch.int64), ("shift", torch.int64),
                   ("qlp", torch.int64), ("plen", torch.int64),
                   ("pesc", torch.int64), ("ps", torch.int64))
_PER_ORDER = ("warm", "qlp")


def _lib() -> ctypes.CDLL:
    lib = _build.load("residual_scan")
    fn = lib.flac_subframe_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_void_p] * len(SUBFRAME_FIELDS)
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_int32] * 4 + [ctypes.c_void_p])
    return lib


def subframe_scan(words, pos, cbps, T: int, maxord: int, wide: bool = False):
    """(sub, res [B, T], pos [B] int64, ovf [B] bool) of one subframe of
    each of B frames, as frame_decoder.subframe_scan returns them: words [W]
    int32 (the stream), pos [B] (each subframe's first header bit) and cbps
    [B] (its sample width, at most 33), all on one CUDA device. `wide`
    launches the wide scan, whose res is int64 (the narrow one's int32)."""
    global launches, wide_launches
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"subframe_scan runs on CUDA tensors, got {dev}")
    if words.dim() != 1 or pos.dim() != 1:
        raise ValueError("subframe_scan: words must be [W] and pos [B]")
    B = pos.shape[0]
    W = words.shape[0]
    if words.device != dev or words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(f"subframe_scan: words must be contiguous int32 on {dev}")
    if cbps.device != dev or tuple(cbps.shape) != (B,):
        raise ValueError(f"subframe_scan: cbps must be [{B}] on {dev}, "
                         f"got {tuple(cbps.shape)} on {cbps.device}")
    if not 0 < T < 2 ** 31 or not 0 <= maxord < 2 ** 31 or B >= 2 ** 31 or W == 0:
        raise ValueError(f"subframe_scan: bad sizes B={B} W={W} T={T} maxord={maxord}")
    pos = pos.to(torch.int64).contiguous()
    cbps = cbps.to(torch.int64).contiguous()
    sub = {name: torch.empty((B, maxord) if name in _PER_ORDER else (B,),
                             dtype=dtype, device=dev)
           for name, dtype in SUBFRAME_FIELDS}
    res = torch.empty((B, T), dtype=torch.int64 if wide else torch.int32, device=dev)
    pos_out = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_subframe_scan(words.data_ptr(), W, pos.data_ptr(), cbps.data_ptr(),
                                    *[sub[name].data_ptr() for name, _ in SUBFRAME_FIELDS],
                                    res.data_ptr(), pos_out.data_ptr(), ovf.data_ptr(),
                                    B, T, maxord, int(wide), stream)
    if rc != 0:
        raise RuntimeError(f"subframe_scan kernel launch failed: CUDA error {rc}")
    if wide:
        wide_launches += 1
    else:
        launches += 1
    return sub, res, pos_out, ovf
