"""The port's frame decoder against flac_tpu's, on the CPU.

`build_frame_decoder(geom, device="cpu")` must give flac_tpu's jitted
decoder's pcm, end bits and every meta array on one geometry (T=1024,
stereo, 16-bit, max_lpc_order=12) with several signals through it (one
compile on the flac_tpu side), and on a 24-bit stream whose Rice outliers
trip the scan's guards, frame by frame. The plain residual scan is held
against `_narrow_residual_scan` on hand-made bit strings at its guards, the
plain restore against the host decoder's restores. Equality throughout:
every output is an integer. The CUDA kernels are held against the plain
versions on the card (`-m cuda`, and chip_smoke.py).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_signal
from flac_tpu.decode import frame_decoder as j_fd
from flac_tpu.decode import host_decoder as j_hd
from flac_tpu.decode.stream import index_frames as j_index_frames
from flac_tpu.encode import encoder as j_enc
from flac_tpu.metadata import parse_metadata
from flac_tpu_torch.decode import frame_decoder as t_fd
from flac_tpu_torch.kernels import residual_scan, restore_scan

T = 1024
GEOM = dict(blocksize=T, channels=2, bits_per_sample=16, sample_rate=44100,
            max_lpc_order=12)


def _stream(tmp_path, sig, bps):
    path = tmp_path / "s.flac"
    j_enc.encode_file(sig, 44100, bps, str(path), level=5, blocksize=T, batch_frames=8)
    data = path.read_bytes()
    d = np.frombuffer(data, np.uint8)
    blocks, ao = parse_metadata(data)
    return j_fd.bytes_to_words(d, bucket=True), j_index_frames(d, ao, blocks[0]) * 8


def _decode_both(words, starts, **geom):
    jg = j_fd.DecoderGeometry(**geom)
    jp, je, jm = j_fd.build_frame_decoder(jg)(jnp.asarray(words), jnp.asarray(starts))
    tg = t_fd.DecoderGeometry.from_dict(dataclasses.asdict(jg))
    tp, te, tm = t_fd.build_frame_decoder(tg, device="cpu")(words, starts)
    assert set(tm) == set(jm)
    return (np.asarray(jp), np.asarray(je), {k: np.asarray(v) for k, v in jm.items()},
            tp.numpy(), te.numpy(), {k: v.numpy() for k, v in tm.items()})


@pytest.mark.parametrize("kind", ["quiet", "noise", "wasted", "sine", "constant"])
def test_frame_decoder_matches_flac_tpu(tmp_path, kind):
    sig = make_signal(4 * T, 2, 16, kind=kind, seed=13)
    words, starts = _stream(tmp_path, sig, 16)
    jp, je, jm, tp, te, tm = _decode_both(words, starts, **GEOM)
    assert tp.dtype == jp.dtype == np.int16
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    assert not tm["unary_overflow"].any()
    np.testing.assert_array_equal(tp.reshape(-1, 2).astype(np.int32), sig)


def test_frame_decoder_24bit_outliers_overflow_alike(tmp_path):
    """Near-silent partitions with full-scale spikes: the outliers trip the
    narrow scan's guards, and `unary_overflow`, which sends a frame to the
    host decoder, must be flac_tpu's frame by frame (and so must the rest)."""
    rng = np.random.default_rng(3)
    amp = (1 << 23) - 1
    x = rng.integers(-3, 4, (4 * T, 2)).astype(np.int32)
    idx = rng.integers(0, len(x), 40)
    x[idx] = rng.integers(-amp - 1, amp + 1, (40, 2)).astype(np.int32)
    words, starts = _stream(tmp_path, x, 24)
    jp, je, jm, tp, te, tm = _decode_both(words, starts, **dict(GEOM, bits_per_sample=24))
    assert jm["unary_overflow"].any()
    np.testing.assert_array_equal(tm["unary_overflow"], jm["unary_overflow"])
    assert tp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)


def _bit_string_words(bits: str) -> np.ndarray:
    bits += "0" * ((-len(bits)) % 32)
    words = np.array([int(bits[i:i + 32], 2) for i in range(0, len(bits), 32)],
                     dtype=np.uint64).astype(np.uint32).view(np.int32)
    return np.concatenate([words, np.zeros(16, np.int32)])


def fold_guard_bit_strings(n: int = 8) -> dict:
    """RICE2 partitions of n samples with k=26 (the bit strings of
    tests/test_device_decoder.py::TestNarrowScan.test_fold_guard, plus a
    unary run of 60 zeros): name -> words."""
    k26 = format(26, "05b")
    tail = ("1" + "0" * 26) * (n - 1)     # q=0, lsb=0 codewords
    lsb = format(0x155AA55 & ((1 << 26) - 1), "026b")
    return {
        "fold_trips": _bit_string_words(k26 + "0" * 47 + "1" + lsb + tail),
        "fold_exact": _bit_string_words(k26 + "0" * 15 + "1" + format(123, "026b") + tail),
        "unary_60": _bit_string_words(k26 + "0" * 60 + "1" + tail),
    }


@pytest.mark.parametrize("name", ["fold_trips", "fold_exact", "unary_60"])
def test_narrow_scan_guards_match(name):
    words = fold_guard_bit_strings()[name]
    n = 8
    jr = j_fd._narrow_residual_scan(
        jnp.asarray(words), jnp.zeros(1, jnp.int64), n, jnp.ones(1, bool),
        jnp.zeros(1, bool), *(jnp.full((1,), v, jnp.int64) for v in (16, 0, 5, 31, n)))
    tr = t_fd.narrow_residual_scan(
        torch.as_tensor(words), torch.zeros(1, dtype=torch.int64), n,
        torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool),
        *(torch.full((1,), v, dtype=torch.int64) for v in (16, 0, 5, 31, n)))
    for got, ref in zip(tr, jr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool(tr[2][0]) == (name != "fold_exact")


def test_restore_scan_matches_host_restores():
    """Random fixed (orders 0-4) and LPC (orders 1-12) frames against
    flac_tpu's host decoder restores; frames that are not coded give 0."""
    rng = np.random.default_rng(11)
    B, n, maxord = 24, 64, 12
    kinds = ["fixed"] * 10 + ["lpc"] * 12 + ["none"] * 2
    order = np.array([i % 5 for i in range(10)] + list(range(1, 13)) + [0, 3])
    shift = np.array([0] * 10 + list(rng.integers(8, 16, 12)) + [0, 0])
    coeffs = np.zeros((B, maxord), np.int64)
    warm = np.zeros((B, maxord), np.int64)
    res = rng.integers(-200, 200, (B, n)).astype(np.int32)
    want = np.zeros((B, n), np.int64)
    for b, kind in enumerate(kinds):
        o = int(order[b])
        warm[b, :o] = rng.integers(-3000, 3000, o)
        if kind == "fixed":
            coeffs[b, :4] = j_fd._FIXED_COEFFS[o]
            want[b] = j_hd._fixed_restore_np(res[b, o:].astype(np.int64),
                                             list(warm[b, :o]), o)
        elif kind == "lpc":
            # sum |q| < 2^shift / 2: a stable filter, no int64 overflow
            lim = (1 << int(shift[b])) // (2 * o)
            q = rng.integers(-lim, lim + 1, o)
            coeffs[b, :o] = q
            coeffs[b, o:] = rng.integers(-99, 99, maxord - o)  # masked by order
            want[b] = j_hd._lpc_restore_np(res[b, o:].astype(np.int64),
                                           list(warm[b, :o]), list(q), int(shift[b]))
    x = t_fd.restore_scan(torch.as_tensor(res), torch.as_tensor(coeffs),
                          torch.as_tensor(order), torch.as_tensor(shift),
                          torch.as_tensor(warm),
                          torch.as_tensor(np.array([k != "none" for k in kinds])),
                          n, maxord)
    np.testing.assert_array_equal(x.numpy(), want)


def test_bit_reads_and_clz():
    rng = np.random.default_rng(4)
    x = np.concatenate([[0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF],
                        rng.integers(0, 1 << 32, 200)]).astype(np.int64)
    ref = np.array([32 - int(v).bit_length() for v in x])
    np.testing.assert_array_equal(t_fd._clz32(torch.as_tensor(x)).numpy(), ref)
    words = _bit_string_words("1" + "0" * 70 + "1" + "000101")
    pos = torch.tensor([0, 1, 30, 71], dtype=torch.int64)
    jq, jp = j_fd._read_unary(jnp.asarray(words), jnp.asarray(pos.numpy()))
    tq, tp = t_fd._read_unary(torch.as_tensor(words), pos)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for n in (0, 3, 17, 32):
        jv, jn = j_fd._read_bits(jnp.asarray(words), jnp.asarray(pos.numpy()), n)
        tv, tn = t_fd._read_bits(torch.as_tensor(words), pos, n)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(t_fd._sign_extend(tv, n).numpy(),
                                      np.asarray(j_fd._sign_extend(jv, n)))


def test_geometry_and_words_match():
    jg = j_fd.DecoderGeometry(blocksize=4096, channels=2, bits_per_sample=16,
                              sample_rate=44100, max_lpc_order=8)
    tg = t_fd.DecoderGeometry.from_dict(dataclasses.asdict(jg))
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert tg.header_ext_bits == jg.header_ext_bits
    odd = j_fd.DecoderGeometry(blocksize=1000, channels=1, bits_per_sample=24,
                               sample_rate=44101)
    assert t_fd.DecoderGeometry.from_dict(dataclasses.asdict(odd)).header_ext_bits \
        == odd.header_ext_bits
    data = np.random.default_rng(2).integers(0, 256, 4097, dtype=np.uint8)
    for n in (4096, 4097):
        for bucket in (False, True):
            np.testing.assert_array_equal(t_fd.bytes_to_words(data[:n], bucket),
                                          j_fd.bytes_to_words(data[:n], bucket))


@pytest.mark.parametrize("geom,env", [
    (dict(GEOM, bits_per_sample=32), None),
    (dict(GEOM, scan_impl="wide"), None),
    (GEOM, "wide"),
    (dict(GEOM, dynamic_header_ext=True), None),
])
def test_unported_decoder_paths_raise(monkeypatch, geom, env):
    if env:
        monkeypatch.setenv("FLAC_TPU_SCAN", env)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_fd.build_frame_decoder(t_fd.DecoderGeometry(**geom), device="cpu")


@pytest.mark.cuda
def test_cuda_decode_kernels_match_plain_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sig = make_signal(4 * T, 2, 16, kind="quiet", seed=13)
    words, starts = _stream(tmp_path, sig, 16)
    words = torch.as_tensor(words, device="cuda")
    geom = t_fd.DecoderGeometry(**GEOM)
    pos, assignment, _ = t_fd.read_frame_header(
        words, torch.as_tensor(starts, device="cuda"), geom.header_ext_bits, 2)
    for c in range(2):
        sub = t_fd.read_subframe_header(
            words, pos, t_fd.side_channel_bps(assignment, c, 16, 2), T, 12)
        args = (words, sub["pos"], T, sub["is_coded"], sub["is_verb"], sub["ebps"],
                sub["order"], sub["plen"], sub["pesc"], sub["ps"])
        before = residual_scan.launches
        got = t_fd.narrow_residual_scan_kernel(*args)
        assert residual_scan.launches == before + 1
        for g, r in zip(got, t_fd.narrow_residual_scan(*args)):
            assert torch.equal(g, r)
        rin = t_fd.restore_inputs(sub, 12)
        before = restore_scan.launches
        x = t_fd.restore_scan_kernel(got[0], *rin, T, 12)
        assert restore_scan.launches == before + 1
        assert torch.equal(x, t_fd.restore_scan(got[0], *rin, T, 12))
        pos = got[1]
    for name, w in fold_guard_bit_strings().items():
        w = torch.as_tensor(w, device="cuda")
        one = torch.ones(1, dtype=torch.bool, device="cuda")
        args = (w, torch.zeros(1, dtype=torch.int64, device="cuda"), 8, one, ~one,
                *(torch.full((1,), v, dtype=torch.int64, device="cuda")
                  for v in (16, 0, 5, 31, 8)))
        for g, r in zip(t_fd.narrow_residual_scan_kernel(*args),
                        t_fd.narrow_residual_scan(*args)):
            assert torch.equal(g, r), name
