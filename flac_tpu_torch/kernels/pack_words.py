"""Launchers of the CUDA pack kernel (csrc/pack_words.cu): `pack_words`, the
banded fill (the port of flac_tpu/encode/packer.py::_pack_words_pallas), and
`pack_words_multi`, the merged-slot fill (the port of
_pack_words_pallas_multi). Each takes a batch of frames' fields, values and
nbits, and makes their words and bit counts in one launch, the prefix sum
inside; given the CRC-16 word tables, it also inserts each frame's CRC-16,
which is all of flac_tpu's pack() stage.

Both take CUDA tensors only and launch their kernel or raise; the routing
between them and the plain PyTorch versions is done by `encode.packer`'s
`pack_fields_kernel`, `pack_fields_merged_kernel` and `pack_frames_kernel`,
which pick by the tensors' device. `launches` and `pack_words_multi.launches`
count the launches of this process; `crc_finish_launches` counts those of the
second kernel that a frame too large for one block's shared tile needs for
its CRC-16.
"""

from __future__ import annotations

import ctypes

import torch

from flac_tpu_torch.kernels import _build

launches = 0
crc_finish_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_words")
    if lib.flac_pack_frames.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.flac_pack_frames.restype = ctypes.c_int
        lib.flac_pack_frames.argtypes = [p, p, p, p, p, p, p, i64, i32, i32, i32,
                                         i32, i32, p]
        lib.flac_pack_frames_crc_finish.restype = ctypes.c_int
        lib.flac_pack_frames_crc_finish.argtypes = [p, p, p, p, i64, i32, i32, p]
        lib.flac_pack_frames_tile_words.restype = ctypes.c_int
        lib.flac_pack_frames_tile_words.argtypes = []
    return lib


def max_tile_words() -> int:
    """Words of one block's shared tile at most: a frame with more words is
    packed by several blocks, one a tile."""
    return int(_lib().flac_pack_frames_tile_words())


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"pack_words: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"pack_words: {name} must be contiguous")


def _pack(values, nbits, maxwords, tbl, inv, merged, tile_words):
    global crc_finish_launches
    if values.device.type != "cuda":
        raise ValueError(f"pack_words runs on CUDA tensors, got {values.device}")
    if values.dim() != 2:
        raise ValueError(f"pack_words: values must be [B, F], got {tuple(values.shape)}")
    B, F = values.shape
    dev = values.device
    _check("values", values, torch.int64, (B, F), dev)
    _check("nbits", nbits, torch.int32, (B, F), dev)
    if not 0 < maxwords < 2 ** 29 or not 0 < F < 2 ** 31:
        raise ValueError(f"pack_words: bad sizes F={F} maxwords={maxwords}")
    crc = tbl is not None or inv is not None
    if crc:
        if tbl is None or inv is None:
            raise ValueError("pack_words: the CRC-16 needs both tbl and inv")
        _check("tbl", tbl, torch.int32, (maxwords,), dev)
        _check("inv", inv, torch.int32, (4 * maxwords + 3,), dev)
    lib = _lib()
    tile = lib.flac_pack_frames_tile_words()
    if tile_words is not None:
        if not 0 < tile_words <= tile:
            raise ValueError(f"pack_words: tile_words must be in (0, {tile}]")
        tile = tile_words
    ntiles = -(-maxwords // tile)
    words = torch.empty((B, maxwords), dtype=torch.int32, device=dev)
    total_bits = torch.empty(B, dtype=torch.int32, device=dev)
    partials = (torch.empty((B, ntiles), dtype=torch.int32, device=dev)
                if crc and ntiles > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flac_pack_frames(
            values.data_ptr(), nbits.data_ptr(), words.data_ptr(),
            total_bits.data_ptr(), tbl.data_ptr() if crc else None,
            inv.data_ptr() if crc else None,
            partials.data_ptr() if partials is not None else None,
            B, F, maxwords, tile, int(merged), int(crc), stream)
        if rc != 0:
            raise RuntimeError(f"pack_words kernel launch failed: CUDA error {rc}")
        if partials is not None:
            rc = lib.flac_pack_frames_crc_finish(
                words.data_ptr(), total_bits.data_ptr(), inv.data_ptr(),
                partials.data_ptr(), B, maxwords, ntiles, stream)
            if rc != 0:
                raise RuntimeError(f"pack_words CRC finish launch failed: CUDA error {rc}")
            crc_finish_launches += 1
    return words, total_bits


def pack_words(values: torch.Tensor, nbits: torch.Tensor, maxwords: int,
               tbl: torch.Tensor | None = None, inv: torch.Tensor | None = None,
               *, tile_words: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The banded fill: (words [B, maxwords] int32, total_bits [B] int32) of
    the fields (values int64 [B, F], pre-masked to their nbits; nbits int32
    [B, F]), all on one CUDA device, in one launch. With tbl and inv
    (packer.crc16_word_tables(maxwords) as int32 device tensors) each frame's
    CRC-16 goes into its last 16 bits, which the fields must leave zero.
    `tile_words` caps the words of one block's tile below max_tile_words()
    (the tiled path, for checks at small sizes)."""
    global launches
    out = _pack(values, nbits, maxwords, tbl, inv, False, tile_words)
    launches += 1
    return out


def pack_words_multi(values: torch.Tensor, nbits: torch.Tensor, maxwords: int,
                     tbl: torch.Tensor | None = None, inv: torch.Tensor | None = None,
                     *, tile_words: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """pack_words by the merged-slot fill: each quad of fields is merged in
    two pairwise rounds (packer.merged_slots) inside the kernel, and its
    slots' contributions (<= 3 a slot) are OR'ed into the words. The same
    outputs, in one launch."""
    out = _pack(values, nbits, maxwords, tbl, inv, True, tile_words)
    pack_words_multi.launches += 1
    return out


pack_words_multi.launches = 0
