"""ctypes bindings to the native C++ host runtime (runtime.cpp).

A copy of flac_tpu's runtime with a loader of its own: the shared library is
compiled with g++ on first import into this package directory (listed in
.gitignore), written under a temporary name and renamed into place so that
concurrent first imports never load a half-written file. Every consumer
degrades to its pure-Python implementation when the toolchain or binary is
unavailable — import failures here must never break the package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "runtime.cpp")
_SO = os.path.join(_HERE, "libflacnative.so")


def _build() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            # fp-contract=off: the ReplayGain dither filter must round
            # every float mul+add separately, as the reference binary
            # (built for baseline x86-64 without FMA) does
            ["g++", "-O3", "-march=native", "-ffp-contract=off",
             "-shared", "-fPIC", "-o", tmp, _SRC],
            capture_output=True, timeout=120)
        if r.returncode != 0:
            return None
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_lib = None
_sopath = _build()
if _sopath:
    try:
        _lib = ctypes.CDLL(_sopath)
    except OSError:
        _lib = None

available = _lib is not None

if _lib is not None:
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _i64p = ctypes.POINTER(ctypes.c_int64)
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    _i32p = ctypes.POINTER(ctypes.c_int32)

    _lib.flacn_rice_read_block.restype = ctypes.c_int
    _lib.flacn_rice_read_block.argtypes = [_u8p, ctypes.c_size_t, _u64p, _i64p,
                                           ctypes.c_size_t, ctypes.c_uint]
    _lib.flacn_read_signed_array.restype = ctypes.c_int
    _lib.flacn_read_signed_array.argtypes = [_u8p, ctypes.c_size_t, _u64p, _i64p,
                                             ctypes.c_size_t, ctypes.c_uint]
    _lib.flacn_read_utf8.restype = ctypes.c_int64
    _lib.flacn_read_utf8.argtypes = [_u8p, ctypes.c_size_t, _u64p]
    _lib.flacn_lpc_restore.restype = None
    _lib.flacn_lpc_restore.argtypes = [_i64p, ctypes.c_size_t, _i32p,
                                       ctypes.c_uint, ctypes.c_int, _i64p]
    _lib.flacn_fixed_restore.restype = None
    _lib.flacn_fixed_restore.argtypes = [_i64p, ctypes.c_size_t, ctypes.c_uint, _i64p]
    _lib.flacn_crc8.restype = ctypes.c_uint8
    _lib.flacn_crc8.argtypes = [_u8p, ctypes.c_size_t]
    _lib.flacn_crc16.restype = ctypes.c_uint16
    _lib.flacn_crc16.argtypes = [_u8p, ctypes.c_size_t]
    _lib.flacn_crc16_many.restype = None
    _lib.flacn_crc16_many.argtypes = [_u8p, ctypes.c_size_t, _i64p, _i64p,
                                      ctypes.c_size_t,
                                      ctypes.POINTER(ctypes.c_uint16)]
    _lib.flacn_find_sync.restype = ctypes.c_int64
    _lib.flacn_find_sync.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_size_t]
    _lib.flacn_md5_digest.restype = None
    _lib.flacn_md5_digest.argtypes = [_u8p, ctypes.c_size_t, _u8p]
    _lib.flacn_md5_sizeof.restype = ctypes.c_size_t
    _lib.flacn_md5_sizeof.argtypes = []
    _lib.flacn_md5_init.restype = None
    _lib.flacn_md5_init.argtypes = [ctypes.c_void_p]
    _lib.flacn_md5_update.restype = None
    _lib.flacn_md5_update.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_size_t]
    _lib.flacn_md5_final.restype = None
    _lib.flacn_md5_final.argtypes = [ctypes.c_void_p, _u8p]
    _lib.flacn_rg_ctx_sizeof.restype = ctypes.c_size_t
    _lib.flacn_rg_ctx_sizeof.argtypes = []
    _lib.flacn_rg_ctx_init.restype = None
    _lib.flacn_rg_ctx_init.argtypes = [ctypes.c_void_p]
    _lib.flacn_rg_apply.restype = None
    _lib.flacn_rg_apply.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_size_t,
                                    ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _i32p]


class NativeBytes:
    """Wrap an immutable byte buffer once for repeated native calls."""

    def __init__(self, data: bytes) -> None:
        self._arr = np.frombuffer(data, np.uint8)
        self.ptr = self._arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self.n = len(data)

    def rice_read_block(self, bitpos: int, n: int, param: int):
        out = np.empty(n, np.int64)
        bp = ctypes.c_uint64(bitpos)
        rc = _lib.flacn_rice_read_block(
            self.ptr, self.n, ctypes.byref(bp),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, param)
        if rc != 0:
            raise EOFError("bit reader exhausted in rice block")
        return out, bp.value

    def read_signed_array(self, bitpos: int, n: int, width: int):
        out = np.empty(n, np.int64)
        bp = ctypes.c_uint64(bitpos)
        rc = _lib.flacn_read_signed_array(
            self.ptr, self.n, ctypes.byref(bp),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, width)
        if rc != 0:
            raise EOFError("bit reader exhausted")
        return out, bp.value

    def find_sync(self, from_byte: int) -> int:
        pos = _lib.flacn_find_sync(self.ptr, self.n, from_byte)
        if pos < 0:
            raise EOFError
        return int(pos)


def lpc_restore(residual: np.ndarray, warmup, qlp, shift: int) -> np.ndarray:
    order = len(qlp)
    res = np.ascontiguousarray(residual, np.int64)
    out = np.empty(order + len(res), np.int64)
    out[:order] = warmup
    q = np.ascontiguousarray(qlp, np.int32)
    _lib.flacn_lpc_restore(
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(res),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), order, shift,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def fixed_restore(residual: np.ndarray, warmup, order: int) -> np.ndarray:
    res = np.ascontiguousarray(residual, np.int64)
    out = np.empty(order + len(res), np.int64)
    out[:order] = warmup
    _lib.flacn_fixed_restore(
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(res), order,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def crc8(data: bytes) -> int:
    arr = np.frombuffer(bytes(data), np.uint8)
    return int(_lib.flacn_crc8(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr)))


def crc16(data: bytes) -> int:
    arr = np.frombuffer(bytes(data), np.uint8)
    return int(_lib.flacn_crc16(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr)))


def crc16_many(data: np.ndarray, offsets: np.ndarray,
               lengths: np.ndarray) -> np.ndarray:
    """CRC-16 of data[offsets[i] : offsets[i]+lengths[i]) for every i, in
    one native call (the decode pipeline's per-batch frame validation)."""
    d = np.ascontiguousarray(data, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lengths, np.int64)
    out = np.empty(len(offs), np.uint16)
    _lib.flacn_crc16_many(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), d.size,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out


def flac_md5_digest(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    out = (ctypes.c_uint8 * 16)()
    _lib.flacn_md5_digest(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if len(arr)
        else ctypes.cast(ctypes.c_char_p(b""), ctypes.POINTER(ctypes.c_uint8)),
        len(arr), ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)))
    return bytes(out)


class StreamingMD5:
    """Streaming FLAC-variant MD5 backed by the native context."""

    def __init__(self) -> None:
        self._ctx = ctypes.create_string_buffer(_lib.flacn_md5_sizeof())
        _lib.flacn_md5_init(self._ctx)

    def update(self, data: bytes) -> None:
        arr = np.frombuffer(data, np.uint8)
        if len(arr) == 0:
            return
        _lib.flacn_md5_update(
            self._ctx, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(arr))

    def digest(self) -> bytes:
        # finalize a copy so the context can keep accumulating
        ctx_copy = ctypes.create_string_buffer(self._ctx.raw)
        out = (ctypes.c_uint8 * 16)()
        _lib.flacn_md5_final(ctx_copy, ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)))
        return bytes(out)


class RgDitherContext:
    """Persistent dither/noise-shaping state across apply calls (the
    reference's DitherContext: RNG polycounters, per-channel dither and
    error-feedback histories, rolling history index)."""

    def __init__(self) -> None:
        self._ctx = ctypes.create_string_buffer(_lib.flacn_rg_ctx_sizeof())
        _lib.flacn_rg_ctx_init(self._ctx)

    def apply(self, pcm: np.ndarray, source_bps: int, target_bps: int,
              scale: float, hard_limit: bool, do_dither: bool,
              shaping: int) -> np.ndarray:
        pcm = np.ascontiguousarray(pcm, np.int32)
        n, ch = pcm.shape
        out = np.empty_like(pcm)
        _lib.flacn_rg_apply(
            self._ctx, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, ch, source_bps, target_bps, float(scale),
            int(hard_limit), int(do_dither), int(shaping),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out


if _lib is None:
    # make `from flac_tpu_torch._native import <fn>` fail cleanly so every consumer
    # falls back to its pure-Python implementation
    del NativeBytes, lpc_restore, fixed_restore, crc8, crc16
    del flac_md5_digest, StreamingMD5, RgDitherContext
