"""The port's frame decoder against flac_tpu's, on the CPU.

`build_frame_decoder(geom, device="cpu")` must give flac_tpu's jitted
decoder's pcm, end bits and every meta array on one geometry (T=1024,
stereo, 16-bit, max_lpc_order=12) with several signals through it (one
compile on the flac_tpu side), and on a 24-bit stream whose Rice outliers
trip the scan's guards, frame by frame. The plain residual scan is held
against `_narrow_residual_scan` on hand-made bit strings at its guards, the
plain restore against the host decoder's restores. Corrupt frames (random
words, wasted-bit runs longer than the sample width, negative bit
positions) decode alike too. Equality throughout: every output is an
integer. The CUDA kernels are held against the plain versions on the card
(`-m cuda`, and chip_smoke.py).
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
from flac_tpu_torch.kernels.residual_scan import SUBFRAME_FIELDS

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


def _put_bits(words: np.ndarray, at: int, bits: str) -> None:
    """Overwrite the bits [at, at + len(bits)) of a big-endian word array."""
    u = words.view(np.uint32)
    for i, ch in enumerate(bits):
        wi, sh = divmod(at + i, 32)
        mask = np.uint32(1 << (31 - sh))
        u[wi] = (u[wi] | mask) if ch == "1" else (u[wi] & ~mask)


def corrupt_frames(seed: int = 21, nwords: int = 4096):
    """Random words and 4 frame starts (the word count and batch of the
    signal cases above, so flac_tpu's decoder is not compiled again). Two
    starts hold a subframe whose wasted-bits run is longer than the sample
    width: a FIXED order-4 one near the stream's start, whose warmup reads
    move the position back below 0 (word indices that wrap once), and a
    VERBATIM one whose samples move it far below (indices clamped to 0)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, nwords, dtype=np.uint64).astype(np.uint32).view(np.int32)
    # frame header: 32 bits, a one-byte frame number, no extension fields
    # at T=1024 / 44.1 kHz, the CRC-8; subframe 0 starts 48 bits in
    starts = [64, int(rng.integers(1000, 40000)), int(rng.integers(40000, 80000)),
              int(rng.integers(80000, 120000))]
    _put_bits(words, starts[0] + 32, "00000000")
    _put_bits(words, starts[0] + 48, "00011001" + "0" * 100 + "1")   # FIXED 4, wasted
    _put_bits(words, starts[3] + 32, "00000000")
    _put_bits(words, starts[3] + 48, "00000011" + "0" * 300 + "1")   # VERBATIM, wasted
    return words, np.array(starts, np.int64)


def test_frame_decoder_matches_flac_tpu_on_corrupt_frames():
    words, starts = corrupt_frames()
    jp, je, jm, tp, te, tm = _decode_both(words, starts, **GEOM)
    assert (jm["wasted"] > 17).any() and (je < 0).any()  # the edges were reached
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)


def test_word_reads_at_negative_positions_match_flac_tpu():
    """flac_tpu's words[min(i, n - 1)] wraps a negative index once and
    clamps what stays below 0; torch indexing would raise."""
    words = np.arange(1, 65, dtype=np.int32) * 0x01010101
    n = len(words) * 32
    pos = np.array([-1, -5, -31, -32, -33, -n + 3, -n, -n - 1, -10 * n - 7,
                    -(1 << 36) - 5, 0, 17, n - 40, n + 9], np.int64)
    jt = j_fd._peek32(jnp.asarray(words), jnp.asarray(pos))
    tt = t_fd._peek32(torch.as_tensor(words), torch.as_tensor(pos))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_subframe_scan_wrapper_on_cpu_is_the_plain_composition():
    """CPU tensors give read_subframe_header + narrow_residual_scan, field
    by field, in the fields, dtypes and shapes the kernel's launcher
    allocates; no launch is counted."""
    words, starts = corrupt_frames()
    words = torch.as_tensor(words)
    geom = t_fd.DecoderGeometry(**GEOM)
    pos, assignment, _ = t_fd.read_frame_header(words, torch.as_tensor(starts),
                                                geom.header_ext_bits, 2)
    cbps = t_fd.side_channel_bps(assignment, 0, 16, 2)
    before = residual_scan.launches
    sub, res, end, ovf = t_fd.subframe_scan_kernel(words, pos, cbps, 64, 12)
    assert residual_scan.launches == before
    ref = t_fd.read_subframe_header(words, pos, cbps, 64, 12)
    assert (ref["pos"] < 0).any()  # the FIXED frame's warmup reads went below 0
    assert list(sub) == list(ref) == [name for name, _ in SUBFRAME_FIELDS]
    for name, dtype in SUBFRAME_FIELDS:
        assert sub[name].dtype == dtype, name
        assert tuple(sub[name].shape) == ((4, 12) if name in ("warm", "qlp") else (4,))
        assert torch.equal(sub[name], ref[name]), name
    want = t_fd.narrow_residual_scan(words, ref["pos"], 64, ref["is_coded"],
                                     ref["is_verb"], ref["ebps"], ref["order"],
                                     ref["plen"], ref["pesc"], ref["ps"])
    for got, exp in zip((res, end, ovf), want):
        assert torch.equal(got, exp)


def test_stacked_restore_equals_per_channel_restores():
    """The frame decoder restores every channel's rows in one call."""
    rng = np.random.default_rng(12)
    B, n, maxord = 6, 48, 12

    def rows():
        order = torch.as_tensor(rng.integers(0, 13, B))
        return (torch.as_tensor(rng.integers(-500, 500, (B, n)).astype(np.int32)),
                torch.as_tensor(rng.integers(-60, 60, (B, maxord))), order,
                torch.as_tensor(rng.integers(0, 9, B)),
                torch.as_tensor(rng.integers(-900, 900, (B, maxord))),
                torch.as_tensor(rng.random(B) < 0.8))

    chans = [rows(), rows()]
    stacked = t_fd.restore_scan_kernel(*[torch.cat(p) for p in zip(*chans)], n, maxord)
    per = torch.cat([t_fd.restore_scan_kernel(*c, n, maxord) for c in chans])
    assert torch.equal(stacked, per)


def _bit_string_words(bits: str) -> np.ndarray:
    bits += "0" * ((-len(bits)) % 32)
    words = np.array([int(bits[i:i + 32], 2) for i in range(0, len(bits), 32)],
                     dtype=np.uint64).astype(np.uint32).view(np.int32)
    return np.concatenate([words, np.zeros(16, np.int32)])


# a FIXED order-0 subframe header, then RICE2 with partition order 0
GUARD_SUBFRAME_HEADER = "00010000" + "01" + "0000"


def fold_guard_bit_strings(n: int = 8, prefix: str = "") -> dict:
    """RICE2 partitions of n samples with k=26 (the bit strings of
    tests/test_device_decoder.py::TestNarrowScan.test_fold_guard, plus a
    unary run of 60 zeros), each behind `prefix`: name -> words."""
    k26 = prefix + format(26, "05b")
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
    """Every case raised once and now builds a decoder: the first three on
    the wide scan, the last with per-frame header widths."""
    if env:
        monkeypatch.setenv("FLAC_TPU_SCAN", env)
    g = t_fd.DecoderGeometry(**geom)
    if g.dynamic_header_ext:
        assert callable(t_fd.build_frame_decoder(g, device="cpu"))
    else:
        assert not t_fd._use_narrow_scan(g)
        assert callable(t_fd.build_frame_decoder(g, device="cpu"))


@pytest.mark.cuda
def test_cuda_decode_kernels_match_plain_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sig = make_signal(4 * T, 2, 16, kind="quiet", seed=13)
    geom = t_fd.DecoderGeometry(**GEOM)
    for words, starts in (_stream(tmp_path, sig, 16), corrupt_frames()):
        words = torch.as_tensor(words, device="cuda")
        pos, assignment, _ = t_fd.read_frame_header(
            words, torch.as_tensor(starts, device="cuda"), geom.header_ext_bits, 2)
        rows = []
        for c in range(2):
            cbps = t_fd.side_channel_bps(assignment, c, 16, 2)
            before = residual_scan.launches
            sub, res, end, ovf = t_fd.subframe_scan_kernel(words, pos, cbps, T, 12)
            assert residual_scan.launches == before + 1
            ref = t_fd.subframe_scan(words, pos, cbps, T, 12)
            for name, _ in SUBFRAME_FIELDS:
                assert torch.equal(sub[name], ref[0][name]), name
            for g, r in zip((res, end, ovf), ref[1:]):
                assert torch.equal(g, r)
            rows.append((res, *t_fd.restore_inputs(sub, 12)))
            pos = end
        stacked = [torch.cat(p) for p in zip(*rows)]
        before = restore_scan.launches
        x = t_fd.restore_scan_kernel(*stacked, T, 12)
        assert restore_scan.launches == before + 1
        assert torch.equal(x, t_fd.restore_scan(*stacked, T, 12))
    for name, w in fold_guard_bit_strings(prefix=GUARD_SUBFRAME_HEADER).items():
        w = torch.as_tensor(w, device="cuda")
        args = (w, torch.zeros(1, dtype=torch.int64, device="cuda"),
                torch.full((1,), 16, dtype=torch.int64, device="cuda"), 8, 12)
        got, ref = t_fd.subframe_scan_kernel(*args), t_fd.subframe_scan(*args)
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), (name, k)
        for g, r in zip(got[1:], ref[1:]):
            assert torch.equal(g, r), name
        assert bool(got[3][0]) == (name != "fold_exact")
