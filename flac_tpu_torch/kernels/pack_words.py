"""Launchers of the CUDA word-fill kernels (csrc/pack_words.cu): `pack_words`,
the port of flac_tpu/encode/packer.py::_pack_words_pallas, and
`pack_words_multi`, the port of _pack_words_pallas_multi.

Both take CUDA tensors only and launch their kernel or raise; the routing
between them and the plain PyTorch versions is done by
`encode.packer.pack_fields_kernel` / `pack_fields_merged_kernel`, which pick
by the tensors' device. `launches` and `pack_words_multi.launches` count
the launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_words")
    for fn in (lib.flac_pack_words, lib.flac_pack_words_multi):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_void_p]
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"pack_words: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"pack_words: {name} must be contiguous")


def pack_words(values: torch.Tensor, ends: torch.Tensor, maxwords: int
               ) -> torch.Tensor:
    """words [B, maxwords] int32 of the fields (values int64 [B, F],
    ends = cumsum(nbits) int32 [B, F]), both on one CUDA device. Values
    must be pre-masked to their nbits."""
    global launches
    if values.device.type != "cuda":
        raise ValueError(f"pack_words runs on CUDA tensors, got {values.device}")
    if values.dim() != 2:
        raise ValueError(f"pack_words: values must be [B, F], got {tuple(values.shape)}")
    B, F = values.shape
    for name, t, dt in (("values", values, torch.int64),
                        ("ends", ends, torch.int32)):
        _check(name, t, dt, (B, F), values.device)
    if not 0 < maxwords < 2 ** 31 or F >= 2 ** 31:
        raise ValueError(f"pack_words: bad sizes F={F} maxwords={maxwords}")
    words = torch.zeros((B, maxwords), dtype=torch.int32, device=values.device)
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.flac_pack_words(values.data_ptr(), ends.data_ptr(),
                                 words.data_ptr(), B, F, maxwords, stream)
    if rc != 0:
        raise RuntimeError(f"pack_words kernel launch failed: CUDA error {rc}")
    launches += 1
    return words


def pack_words_multi(values: torch.Tensor, ends: torch.Tensor,
                     words: torch.Tensor) -> torch.Tensor:
    """OR the word contributions of merged slots (values int64 [B, S], each
    < 2^63; ends int32 [B, S]) into `words` int32 [B, maxwords], in place,
    on one CUDA device; returns `words`. Contribution j of a slot lands in
    word we - j, j < 3."""
    if values.device.type != "cuda":
        raise ValueError(f"pack_words_multi runs on CUDA tensors, got {values.device}")
    if values.dim() != 2 or words.dim() != 2:
        raise ValueError("pack_words_multi: values and words must be 2-D")
    B, S = values.shape
    maxwords = words.shape[1]
    _check("values", values, torch.int64, (B, S), values.device)
    _check("ends", ends, torch.int32, (B, S), values.device)
    _check("words", words, torch.int32, (B, maxwords), values.device)
    if not 0 < maxwords < 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"pack_words_multi: bad sizes S={S} maxwords={maxwords}")
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.flac_pack_words_multi(values.data_ptr(), ends.data_ptr(),
                                       words.data_ptr(), B, S, maxwords, stream)
    if rc != 0:
        raise RuntimeError(f"pack_words_multi kernel launch failed: CUDA error {rc}")
    pack_words_multi.launches += 1
    return words


pack_words_multi.launches = 0
