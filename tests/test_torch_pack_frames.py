"""The port's pack stage against flac_tpu's, bit for bit: `pack_frames_kernel`
(one launch of the fused CUDA kernel on a GPU; on CPU tensors the plain
word fill, `crc16_from_words` and `insert_crc16`) on the cases of
tests/test_packer_pallas.py with a byte-align pad and a zero CRC-16 slot
appended, for the banded and the merged fill, against flac_tpu's
pack_fields -> crc16_from_words -> insert_crc16 under jit on the CPU; and the
frame encoder's pack() on one small level-5 batch against flac_tpu's. The
CUDA kernel itself, both fills, fused and fill-only, one block a frame and
split into word tiles, is held against the plain versions on the card
(`-m cuda`, and chip_smoke.py)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_pcm
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu.encode import packer as j_packer
from flac_tpu_torch.encode import frame_encoder as t_fe
from flac_tpu_torch.encode import packer as t_packer
from flac_tpu_torch.kernels import pack_words
from test_torch_packer import CASES, _case


def _with_crc_slot(name):
    """A case as the frame assembler leaves a frame: a byte-align pad and a
    zero 16-bit CRC slot appended, two more words of room."""
    values, nbits, maxwords = _case(name)
    B = len(values)
    pad = (-(nbits.sum(1) + 16)) % 8
    nbits = np.concatenate([nbits, pad[:, None], np.full((B, 1), 16)], 1).astype(np.int32)
    values = np.concatenate([values, np.zeros((B, 2), np.int64)], 1)
    return values, nbits, maxwords + 2


def _flac_tpu_pack(values, nbits, maxwords):
    tbl, inv = j_packer.crc16_word_tables(maxwords)

    def pack(v, n, tbl, inv):
        words, total = j_packer.pack_fields(v, n, maxwords)
        crc = j_packer.crc16_from_words(words, total, tbl, inv)
        return j_packer.insert_crc16(words, total, crc), total

    words, total = jax.jit(pack)(values, nbits, tbl, inv)
    return np.asarray(words), np.asarray(total)


def _counts():
    return (pack_words.launches, pack_words.pack_words_multi.launches,
            pack_words.crc_finish_launches)


@pytest.mark.parametrize("merged", [False, True], ids=["banded", "merged"])
@pytest.mark.parametrize("name", CASES)
def test_plain_pack_frames_matches_flac_tpu(name, merged):
    values, nbits, maxwords = _with_crc_slot(name)
    ref_w, ref_t = _flac_tpu_pack(values, nbits, maxwords)
    tbl, inv = (torch.as_tensor(t) for t in t_packer.crc16_word_tables(maxwords))
    before = _counts()
    got_w, got_t = t_packer.pack_frames_kernel(torch.as_tensor(values),
                                               torch.as_tensor(nbits), maxwords,
                                               tbl, inv, merged)
    assert _counts() == before  # CPU tensors never reach a launcher
    assert got_w.dtype == torch.int32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), ref_t)
    np.testing.assert_array_equal(got_w.numpy(), ref_w)


@pytest.mark.parametrize("impl", ["pallas", "merged"])
def test_pack_stage_matches_flac_tpu(impl):
    """build_frame_encoder_parts' fields of one level-5 stereo batch (B=4,
    T=1024) through pack_frames with each fill, and through the parts'
    pack() (the banded fill), against flac_tpu's pack stage on the same
    fields."""
    B, T = 4, 1024
    tc = t_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    jc = j_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    fields_fn, pack_fn = t_fe.build_frame_encoder_parts(tc, device="cpu")
    values, nbits, _ = fields_fn(_tiny_pcm(B, T), np.arange(B, dtype=np.int64))
    _, j_pack = j_fe.build_frame_encoder_parts(jc, packer_impl="xla")
    ref_w, ref_t = jax.jit(j_pack)(values.numpy(), nbits.numpy())
    maxwords = t_fe.max_frame_bytes(tc, T) // 4
    tbl, inv = (torch.as_tensor(t) for t in t_packer.crc16_word_tables(maxwords))
    for got_w, got_t in (t_packer.pack_frames(values, nbits, maxwords, tbl, inv,
                                              merged=impl == "merged"),
                         pack_fn(values, nbits)):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))


def _cuda_case(name):
    values, nbits, maxwords = _with_crc_slot(name)
    tbl, inv = t_packer.crc16_word_tables(maxwords)
    return [torch.as_tensor(a, device="cuda") for a in (values, nbits, tbl, inv)], maxwords


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True], ids=["banded", "merged"])
@pytest.mark.parametrize("name", CASES)
def test_cuda_fused_kernel_matches_plain_on_card(name, merged):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    (v, n, tbl, inv), maxwords = _cuda_case(name)
    before = _counts()
    got_w, got_t = t_packer.pack_frames_kernel(v, n, maxwords, tbl, inv, merged)
    ref_w, ref_t = t_packer.pack_frames(v, n, maxwords, tbl, inv, merged)
    one = (0, 1, 0) if merged else (1, 0, 0)
    assert _counts() == tuple(b + d for b, d in zip(before, one))
    assert torch.equal(got_t, ref_t)
    assert torch.equal(got_w, ref_w)


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True], ids=["banded", "merged"])
def test_cuda_tiled_path_matches_plain_on_card(merged):
    """Frames split into word tiles of 32 words, one block each: both modes,
    and the second kernel that inserts the CRC-16 once a fused call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    launch = pack_words.pack_words_multi if merged else pack_words.pack_words
    fill = t_packer.pack_fields_merged if merged else t_packer.pack_fields
    for name in CASES:
        (v, n, tbl, inv), maxwords = _cuda_case(name)
        finishes = pack_words.crc_finish_launches
        got = launch(v, n, maxwords, tbl, inv, tile_words=32)
        ref = t_packer.pack_frames(v, n, maxwords, tbl, inv, merged)
        assert pack_words.crc_finish_launches == finishes + (maxwords > 32)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), name
        got = launch(v, n, maxwords, tile_words=32)
        assert pack_words.crc_finish_launches == finishes + (maxwords > 32)
        assert all(torch.equal(a, b) for a, b in zip(got, fill(v, n, maxwords))), name
