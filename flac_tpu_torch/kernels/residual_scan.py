"""Launcher of the CUDA subframe scan (csrc/residual_scan.cu): the
subframe-header parse and the residual/verbatim scan in one launch, the
port of flac_tpu/decode/frame_decoder.py's `_decode_subframe` parse with
`_narrow_residual_scan` (the narrow kernel) or with its wide branch (the
wide kernel).

`subframe_scan` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`decode.frame_decoder.subframe_scan_kernel`, which picks by the tensors'
device. `launches` counts the narrow kernel's launches of this process,
`wide_launches` the wide kernel's. `exact_path_frames` reads how many
frames the wide kernel sent to its exact path (flac_tpu's window scan, step
for step) since it was last read.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build
from flac_tpu_torch.kernels._build import KernelError

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


def subframe_scan(words, pos, cbps, T: int, maxord: int, wide: bool = False,
                  exact: bool = False):
    """(sub, res [B, T], pos [B] int64, ovf [B] bool) of one subframe of
    each of B frames, as frame_decoder.subframe_scan returns them: words [W]
    int32 (the stream), pos [B] (each subframe's first header bit) and cbps
    [B] (its sample width, at most 33), all on one CUDA device. `wide`
    launches the wide scan, whose res is int64 (the narrow one's int32);
    `exact` sends every frame of it to its exact path, to time that path."""
    global launches, wide_launches
    dev = pos.device
    if dev.type != "cuda":
        raise KernelError(f"subframe_scan runs on CUDA tensors, got {dev}")
    if words.dim() != 1 or pos.dim() != 1:
        raise KernelError("subframe_scan: words must be [W] and pos [B]")
    B = pos.shape[0]
    W = words.shape[0]
    if words.device != dev or words.dtype != torch.int32 or not words.is_contiguous():
        raise KernelError(f"subframe_scan: words must be contiguous int32 on {dev}")
    if cbps.device != dev or tuple(cbps.shape) != (B,):
        raise KernelError(f"subframe_scan: cbps must be [{B}] on {dev}, "
                          f"got {tuple(cbps.shape)} on {cbps.device}")
    if exact and not wide:
        raise KernelError("subframe_scan: the exact path is the wide scan's")
    if not 0 < T < 2 ** 31 or not 0 <= maxord < 2 ** 31 or B >= 2 ** 31 or W == 0:
        raise KernelError(f"subframe_scan: bad sizes B={B} W={W} T={T} maxord={maxord}")
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
                                    B, T, maxord, 2 if exact else int(wide),
                                    stream)
    if rc != 0:
        raise KernelError(f"subframe_scan kernel launch failed: CUDA error {rc}")
    if wide:
        wide_launches += 1
    else:
        launches += 1
    return sub, res, pos_out, ovf


def exact_path_frames() -> int:
    """Frames the wide kernel sent to its exact path since the last call
    (flagged frames, negative positions, VERBATIM widths outside [1, 33]);
    waits for the device and resets the count."""
    lib = _lib()
    fn = lib.flac_subframe_scan_exact_frames
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    torch.cuda.synchronize()
    count = ctypes.c_ulonglong(0)
    rc = fn(ctypes.byref(count))
    if rc != 0:
        raise KernelError(f"subframe_scan: reading the exact-path count failed: CUDA error {rc}")
    return int(count.value)


def walk_latency_probe(iters: int, device: str | torch.device = "cuda") -> float:
    """Device milliseconds of one thread running `iters` dependent steps of
    the wide scan's walk (its chain alone), by CUDA events around one
    launch. The caller takes the difference of two lengths to cancel the
    launch."""
    dev = torch.device(device)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _lib()
    fn = lib.flac_walk_latency_probe
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = fn(iters, out.data_ptr(), stream.cuda_stream)
        stop.record(stream)
    if rc != 0:
        raise KernelError(f"walk latency probe launch failed: CUDA error {rc}")
    stop.synchronize()
    return start.elapsed_time(stop)
