"""Launcher of the CUDA equal-loudness filter (csrc/iir_scan.cu), the port of
flac_tpu/replaygain/__init__.py::_iir_scan run as ReplayGain's two stages.

`equal_loudness` takes CUDA tensors only and launches the kernel or raises;
the routing between it and the plain PyTorch version is done by
`replaygain.equal_loudness`, which picks by the tensor's device. `launches`
counts the launches of this process. `fp64_latency_probe` serves the
kernel's bound: it is no part of the filter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flac_tpu_torch.kernels import _build

launches = 0
N_TAPS = 26  # Yule b[0..10], a[1..10]; Butterworth b[0..2], a[1..2]


def _lib() -> ctypes.CDLL:
    lib = _build.load("iir_scan")
    fn = lib.flac_equal_loudness
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int32, ctypes.c_int64] \
            + [ctypes.c_void_p] * 2
        probe = lib.flac_fp64_latency_probe
        probe.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def equal_loudness(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Both IIR stages over x [C, n] float64 (1 <= C <= 32) on a CUDA
    device, from zero state; returns the Butterworth stage's output [C, n]
    float64 there. `taps`: the 26 float64 taps in the order of N_TAPS."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"equal_loudness runs on CUDA tensors, got {dev}")
    if x.dim() != 2 or x.dtype != torch.float64 or not 1 <= x.shape[0] <= 32:
        raise ValueError(f"equal_loudness: x must be float64 [C, n] with 1 <= C <= 32, "
                         f"got {x.dtype} {tuple(x.shape)}")
    taps = np.ascontiguousarray(taps, np.float64)
    if taps.shape != (N_TAPS,):
        raise ValueError(f"equal_loudness: {N_TAPS} taps expected, got {taps.shape}")
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_equal_loudness(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                                     taps.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"equal_loudness kernel launch failed: CUDA error {rc}")
    launches += 1
    return y


def fp64_latency_probe(iters: int, op: str = "fma",
                       device: str | torch.device = "cuda") -> float:
    """Device milliseconds of one thread running `iters` (a multiple of 8)
    dependent float64 operations, `op` "fma" or "add", by CUDA events
    around one launch. The caller takes the difference of two lengths to
    cancel the launch."""
    if op not in ("fma", "add"):
        raise ValueError(f"fp64_latency_probe: op must be 'fma' or 'add', got {op!r}")
    dev = torch.device(device)
    out = torch.empty(1, dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = lib.flac_fp64_latency_probe(iters, int(op == "add"), out.data_ptr(),
                                         stream.cuda_stream)
        stop.record(stream)
    if rc != 0:
        raise RuntimeError(f"fp64 latency probe launch failed: CUDA error {rc}")
    stop.synchronize()
    return start.elapsed_time(stop)
