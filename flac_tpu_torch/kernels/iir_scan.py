"""Launcher of the CUDA equal-loudness filter (csrc/iir_scan.cu), the port of
flac_tpu/replaygain/__init__.py::_iir_scan run as ReplayGain's two stages.

The kernel filters many channels of unequal length in one launch, one
thread block a channel. Its input is a ragged layout: one packed float64
buffer, each title's channels one after another, each channel (segment) at
an offset that is a multiple of TILE and zero-padded to whole tiles
(`ragged_layout`, `pack_ragged`, `unpack_ragged`; plain PyTorch, so the
CPU tests reach them).

- `equal_loudness_ragged(buf, segs, taps)` is the launch itself (an
  album: `replaygain.equal_loudness_album` packs its titles for it);
- `equal_loudness(x, taps)` is the one-title form.

Both take CUDA tensors only and launch the kernel or raise; the routing
between them and the plain PyTorch version is done by `replaygain`, which
picks by the tensor's device. `launches` counts the launches of this
process. `fp64_latency_probe` serves the kernel's bound: it is no part of
the filter.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from flac_tpu_torch.kernels import _build

launches = 0
N_TAPS = 26  # Yule b[0..10], a[1..10]; Butterworth b[0..2], a[1..2]
TILE = 256   # samples a tile of the kernel (kTile in csrc/iir_scan.cu)


def _lib() -> ctypes.CDLL:
    lib = _build.load("iir_scan")
    fn = lib.flac_equal_loudness
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] + [ctypes.c_void_p] * 2
        probe = lib.flac_fp64_latency_probe
        probe.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        if lib.flac_equal_loudness_tile() != TILE:
            raise RuntimeError("csrc/iir_scan.cu's tile is not iir_scan.TILE")
    return lib


def padded(n):
    """n samples (an int or an integer array) rounded up to whole tiles."""
    return -(-n // TILE) * TILE


def ragged_layout(shapes: Sequence[tuple[int, int]]) -> tuple[np.ndarray, int]:
    """The layout of titles of shapes [(C_k, n_k), ...] in one buffer: each
    title's C_k channels one after another, each padded to whole tiles.
    Returns segs, int64 [sum C_k, 2] of (offset, length) in title then
    channel order, and the buffer's length in samples."""
    segs, total = [], 0
    for c, n in shapes:
        if c < 1 or n < 0:
            raise ValueError(f"ragged_layout: a title of {c} channels and {n} samples")
        for _ in range(c):
            segs.append((total, n))
            total += padded(n)
    return np.asarray(segs, np.int64).reshape(-1, 2), total


def pack_ragged(xs: Sequence[torch.Tensor]) -> tuple[torch.Tensor, np.ndarray]:
    """Titles xs[k] [C_k, n_k] float64 into one zero-padded buffer on their
    device, as `ragged_layout` places them; returns (buf, segs)."""
    for x in xs:
        if x.dim() != 2 or x.dtype != torch.float64:
            raise ValueError(f"pack_ragged: titles must be float64 [C, n], got "
                             f"{x.dtype} {tuple(x.shape)}")
    segs, total = ragged_layout([tuple(x.shape) for x in xs])
    buf = torch.zeros(total, dtype=torch.float64, device=xs[0].device)
    row = 0
    for x in xs:
        for c in range(x.shape[0]):
            off, n = segs[row]
            buf[off:off + n] = x[c]
            row += 1
    return buf, segs


def unpack_ragged(buf: torch.Tensor, shapes: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """The titles [C_k, n_k] back out of a buffer in `ragged_layout`'s
    places: views of buf (rows n_k long at a stride of whole tiles)."""
    out, base = [], 0
    for c, n in shapes:
        p = padded(n)
        out.append(buf[base:base + c * p].view(c, p)[:, :n])
        base += c * p
    return out


def _check_segs(segs, size: int) -> np.ndarray:
    segs = np.asarray(segs)
    if segs.ndim != 2 or segs.shape[1] != 2 or segs.shape[0] < 1 \
            or not np.issubdtype(segs.dtype, np.integer):
        raise ValueError(f"equal_loudness_ragged: segs must be integer (offset, length) "
                         f"pairs [S, 2], S >= 1, got {segs.dtype} {segs.shape}")
    segs = segs.astype(np.int64)
    off, n = segs[:, 0], segs[:, 1]
    if (n < 0).any():
        raise ValueError("equal_loudness_ragged: a segment has a negative length")
    if (off % TILE).any():
        raise ValueError(f"equal_loudness_ragged: segment offsets must be multiples of "
                         f"{TILE} samples")
    end = off + padded(n)  # the segment's whole tiles
    if (off < 0).any() or (end > size).any():
        raise ValueError(f"equal_loudness_ragged: a segment's tiles leave the buffer of "
                         f"{size} samples")
    used = n > 0
    order = np.argsort(off[used], kind="stable")
    o, e = off[used][order], end[used][order]
    if (o[1:] < e[:-1]).any():
        raise ValueError("equal_loudness_ragged: segments overlap")
    return segs


def equal_loudness_ragged(buf: torch.Tensor, segs, taps: np.ndarray) -> torch.Tensor:
    """Both IIR stages, from zero state, over every segment (offset, length)
    of buf (1-D float64, on a CUDA device) in one launch, one block a
    segment. Offsets are multiples of TILE and each segment's whole tiles
    lie inside buf without overlapping another's; the samples between a
    segment's end and its last tile's end are zeros (`pack_ragged` makes
    them so) and their outputs are not the filter's. Returns the output
    buffer of buf's size; only each segment's first `length` samples hold
    the filter's output. `taps`: the 26 float64 taps in the order of
    N_TAPS. Checks every argument before it loads the library."""
    global launches
    if not isinstance(buf, torch.Tensor) or buf.dtype != torch.float64:
        raise ValueError(f"equal_loudness_ragged: buf must be a float64 tensor, got "
                         f"{getattr(buf, 'dtype', type(buf))}")
    if buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"equal_loudness_ragged: buf must be 1-D and contiguous, got "
                         f"{tuple(buf.shape)}")
    segs = _check_segs(segs, buf.numel())
    taps = np.ascontiguousarray(taps, np.float64)
    if taps.shape != (N_TAPS,):
        raise ValueError(f"equal_loudness_ragged: {N_TAPS} taps expected, got {taps.shape}")
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"equal_loudness_ragged runs on CUDA tensors, got {dev}")
    if buf.data_ptr() % 16:
        raise ValueError("equal_loudness_ragged: buf must be 16-byte aligned (bulk copies)")
    y = torch.empty_like(buf)
    segs_dev = torch.from_numpy(segs).to(dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_equal_loudness(buf.data_ptr(), y.data_ptr(), segs_dev.data_ptr(),
                                     segs.shape[0], taps.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"equal_loudness kernel launch failed: CUDA error {rc}")
    launches += 1
    return y


def equal_loudness(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Both IIR stages over one title x [C, n] float64 on a CUDA device, one
    segment a row, from zero state, in one launch; returns the Butterworth
    stage's output [C, n] there."""
    buf, segs = pack_ragged([x])
    return unpack_ragged(equal_loudness_ragged(buf, segs, taps), [tuple(x.shape)])[0]


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
