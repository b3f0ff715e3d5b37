"""The port's field packer against flac_tpu's: the plain word fill, the
merge round and the plain merged fill, the CRC-8 field reduction and the
word-level CRC-16, bit for bit, on the cases of tests/test_packer_pallas.py
(inputs from their seeds, numpy). One small case of the banded fill and the
two degenerate cases of the merged fill are also held against flac_tpu's
Pallas kernels in interpret mode (the random cases of the merged fill are in
test_torch_packer_merged.py, to keep each file short). The CUDA kernels
themselves are held against their plain versions on the card (`-m cuda`,
and chip_smoke.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu import crc as j_crc
from flac_tpu.encode import packer as j_packer
from flac_tpu_torch.encode import packer as t_packer
from flac_tpu_torch.kernels import pack_words


def _random_fields(rng, B, F, maxwords, long_frac=0.05):
    """tests/test_packer_pallas.py::_random_fields, kept in numpy."""
    nbits = rng.integers(0, 34, size=(B, F)).astype(np.int32)
    longm = rng.random((B, F)) < long_frac
    nbits = np.where(longm, rng.integers(34, 90, size=(B, F)), nbits)
    tot = nbits.sum(1)
    while (tot > maxwords * 32 - 32).any():
        nbits = np.where((tot > maxwords * 32 - 32)[:, None], nbits // 2, nbits)
        tot = nbits.sum(1)
    sig = np.minimum(nbits, 33).astype(np.int64)
    values = rng.integers(0, 1 << 62, size=(B, F)) & ((1 << sig) - 1)
    return values, nbits.astype(np.int32)


def _case(name):
    """(values int64 [B, F], nbits int32 [B, F], maxwords)."""
    if name.startswith("random"):
        i = int(name[-1])
        B, F, maxwords = [(8, 300, 96), (8, 130, 6), (9, 257, 520)][i]
        return (*_random_fields(np.random.default_rng(7 * i + 1), B, F, maxwords),
                maxwords)
    if name == "zero_runs":  # thousands of zero-length fields in one word
        rng = np.random.default_rng(42)
        nbits = np.zeros((8, 1400), np.int32)
        nbits[:, 0], nbits[:, 700], nbits[:, -1] = 20, 33, 33
        sig = np.minimum(nbits, 33).astype(np.int64)
        return rng.integers(0, 1 << 62, size=(8, 1400)) & ((1 << sig) - 1), nbits, 40
    assert name == "all_33bit"
    rng = np.random.default_rng(5)
    return rng.integers(0, 1 << 33, size=(8, 64)), np.full((8, 64), 33, np.int32), 70


CASES = ["random0", "random1", "random2", "zero_runs", "all_33bit"]


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("name", CASES)
def test_plain_pack_fields_matches(name):
    values, nbits, maxwords = _case(name)
    ref_w, ref_t = j_packer.pack_fields(jnp.asarray(values), jnp.asarray(nbits), maxwords)
    got_w, got_t = t_packer.pack_fields(torch.as_tensor(values),
                                        torch.as_tensor(nbits), maxwords)
    assert got_w.dtype == torch.int32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))


def test_plain_pack_matches_pallas_kernel_interpret():
    values, nbits, maxwords = _case("random1")
    ref_w, ref_t = j_packer.pack_fields_pallas(jnp.asarray(values), jnp.asarray(nbits),
                                               maxwords, interpret=True)
    got_w, got_t = t_packer.pack_fields_kernel(torch.as_tensor(values),
                                               torch.as_tensor(nbits), maxwords)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(_u32(got_w), _u32(ref_w))


def _merged_matches_interpret(name):
    values, nbits, maxwords = _case(name)
    ref_w, ref_t = j_packer.pack_fields_pallas_merged(
        jnp.asarray(values), jnp.asarray(nbits), maxwords, interpret=True)
    got_w, got_t = t_packer.pack_fields_merged(torch.as_tensor(values),
                                               torch.as_tensor(nbits), maxwords)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(_u32(got_w), _u32(ref_w))


@pytest.mark.parametrize("name", ["zero_runs", "all_33bit"])
def test_plain_merged_fill_matches_pallas_merged_interpret(name):
    """Thousands of empty fields in one word, and adjacent 33-bit fields (no
    pair fits in 63 bits: every round spills, test_merged_all_spill)."""
    _merged_matches_interpret(name)


@pytest.mark.parametrize("name", CASES)
def test_merge_round_matches(name):
    """Both merge rounds, as pack_fields_pallas_merged runs them."""
    values, nbits, _ = _case(name)
    ends = np.cumsum(nbits, axis=1)
    v = np.where(nbits > 0, values, 0).astype(np.int64)
    sig = np.minimum(nbits, 33).astype(np.int32)
    jv, je, js = jnp.asarray(v), jnp.asarray(ends.astype(np.int64)), jnp.asarray(sig)
    tv, te, ts = torch.as_tensor(v), torch.as_tensor(ends.astype(np.int64)), torch.as_tensor(sig)
    for _ in range(t_packer.MERGE_ROUNDS):
        if tv.shape[1] % 2:
            jv, js = jnp.pad(jv, ((0, 0), (0, 1))), jnp.pad(js, ((0, 0), (0, 1)))
            je = jnp.pad(je, ((0, 0), (0, 1)), mode="edge")
            tv, ts = (torch.nn.functional.pad(x, (0, 1)) for x in (tv, ts))
            te = torch.cat([te, te[:, -1:]], dim=1)
        (jv, je, js), jspill = j_packer._merge_round(jv, je, js)
        (tv, te, ts), tspill = t_packer._merge_round(tv, te, ts)
        for got, ref in zip((tv, te, ts) + tspill, (jv, je, js) + jspill):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", CASES)
def test_plain_merged_fill_matches_banded(name):
    values, nbits, maxwords = _case(name)
    v, n = torch.as_tensor(values), torch.as_tensor(nbits)
    got_w, got_t = t_packer.pack_fields_merged(v, n, maxwords)
    ref_w, ref_t = t_packer.pack_fields(v, n, maxwords)
    assert torch.equal(got_t, ref_t) and torch.equal(got_w, ref_w)


@pytest.mark.parametrize("name", CASES)
def test_crc_reduce_matches(name):
    """CRC-8 of a field prefix, as the frame header's CRC-8 uses it."""
    values, nbits, _ = _case(name)
    values = values & ((1 << np.minimum(nbits, 33).astype(np.int64)) - 1)
    ends = np.cumsum(nbits, axis=1).astype(np.int32)
    msg_end = ends[:, -1] - np.random.default_rng(9).integers(0, 9, len(ends))
    include = np.random.default_rng(10).random(values.shape) < 0.9
    table = j_packer.xpow_table_np(4096, j_crc.CRC8_POLY, 8)
    ref = jax.jit(j_packer.crc_reduce, static_argnums=(5, 6))(
        jnp.asarray(values), jnp.asarray(ends), jnp.asarray(msg_end),
        jnp.asarray(include), jnp.asarray(table), j_crc.CRC8_POLY, 8)
    got = t_packer.crc_reduce(torch.as_tensor(values), torch.as_tensor(ends),
                              torch.as_tensor(msg_end), torch.as_tensor(include),
                              torch.as_tensor(table), j_crc.CRC8_POLY, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", CASES)
def test_crc16_from_words_and_insert_match(name):
    """Frames made byte-aligned with a zero 16-bit CRC slot, as the frame
    assembler leaves them; the inserted CRC must equal the byte-serial
    CRC-16 of the frame."""
    values, nbits, maxwords = _case(name)
    B = len(values)
    pad = (-(nbits.sum(1) + 16)) % 8
    nbits = np.concatenate([nbits, pad[:, None], np.full((B, 1), 16)], 1).astype(np.int32)
    values = np.concatenate([values, np.zeros((B, 2), np.int64)], 1)
    maxwords += 2
    words, total = j_packer.pack_fields(jnp.asarray(values), jnp.asarray(nbits), maxwords)
    tbl, inv = j_packer.crc16_word_tables(maxwords)
    ref_crc = j_packer.crc16_from_words(words, total, jnp.asarray(tbl), jnp.asarray(inv))
    ref_words = j_packer.insert_crc16(words, total, ref_crc)
    tw, tt = torch.tensor(np.asarray(words)), torch.tensor(np.asarray(total))
    got_crc = t_packer.crc16_from_words(tw, tt, torch.as_tensor(tbl), torch.as_tensor(inv))
    np.testing.assert_array_equal(got_crc.numpy(), np.asarray(ref_crc))
    got_words = t_packer.insert_crc16(tw, tt, got_crc)
    np.testing.assert_array_equal(got_words.numpy(), np.asarray(ref_words))
    for b in range(B):
        frame = np.asarray(words[b]).astype(">u4").tobytes()[: int(total[b]) // 8]
        assert j_crc.crc16(frame[:-2]) == int(got_crc[b])
    host = got_words.numpy()
    np.testing.assert_array_equal(
        t_packer.stream_words_to_bytes(host, 4 * host.size - 3),
        j_packer.stream_words_to_bytes(np.asarray(ref_words), 4 * host.size - 3))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    values, nbits, maxwords = _case(name)
    v = torch.as_tensor(values, device="cuda")
    n = torch.as_tensor(nbits, device="cuda")
    before = pack_words.launches
    got_w, got_t = t_packer.pack_fields_kernel(v, n, maxwords)
    ref_w, ref_t = t_packer.pack_fields(v, n, maxwords)
    assert pack_words.launches == before + 1
    assert torch.equal(got_t, ref_t)
    assert torch.equal(got_w, ref_w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_merged_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    values, nbits, maxwords = _case(name)
    v = torch.as_tensor(values, device="cuda")
    n = torch.as_tensor(nbits, device="cuda")
    before = pack_words.pack_words_multi.launches
    got_w, got_t = t_packer.pack_fields_merged_kernel(v, n, maxwords)
    ref_w, ref_t = t_packer.pack_fields_merged(v, n, maxwords)
    assert pack_words.pack_words_multi.launches == before + 1
    assert torch.equal(got_t, ref_t)
    assert torch.equal(got_w, ref_w)
