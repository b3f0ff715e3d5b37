"""ReplayGain through the port against flac_tpu, on the CPU.

- The plain IIR (`iir_filter`, `equal_loudness` on CPU tensors) against
  flac_tpu's `_iir_scan` per stage and as the cascade, at three rates. The
  port sums in another order than flac_tpu's chains of fused multiply-adds
  (the order the CUDA kernel keeps), so the outputs agree within 1e-9 of the
  output's peak: float64 rounding is about 1e-16 of it, and the filters'
  recursions magnify it to at most about 1e-11 at 96 kHz.
- `fma_reference`, the CUDA kernel's arithmetic step by step in exact
  rationals, equals `_iir_scan` bit for bit (on 400 samples a channel).
- The gains, peaks and tag strings are equal exactly: the window statistics
  are flac_tpu's, in numpy, on the filtered signal. The album is filtered
  together (`equal_loudness_album`, one kernel launch on CUDA tensors, the
  plain version a title on CPU tensors); `compute_replay_gain` splits it
  into groups above LAUNCH_BYTES, with the same results.
- The kernel's ragged layout (offsets on whole tiles, zero padding, the
  split back to the titles) round-trips, and its launcher checks its input
  before it loads the library.
- Tagging, loading and gain application give byte- and int32-identical
  results.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from flac_tpu import replaygain as j_rg
from flac_tpu_torch import replaygain as t_rg
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.kernels import iir_scan
from flac_tpu_torch.metadata import Padding, VorbisComment

REL_TOL = 1e-9  # of the output's peak


def _tone(n, rate, amp, bps=16, ch=2, seed=0, freq=997.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = amp * np.sin(2 * np.pi * freq * t) + amp * 0.3 * np.sin(2 * np.pi * 131.0 * t)
    out = np.stack([x, 0.8 * x], axis=1)[:, :ch] + rng.normal(0, amp * 0.05, (n, ch))
    lim = (1 << (bps - 1)) - 1
    return np.clip(np.round(out), -lim - 1, lim).astype(np.int32)


def _close(got: np.ndarray, ref: np.ndarray) -> None:
    peak = float(np.abs(ref).max())
    assert peak > 0
    assert float(np.abs(got - ref).max()) <= REL_TOL * peak


@pytest.mark.parametrize("rate", [44100, 96000, 8000])
def test_iir_filter_matches_iir_scan(rate):
    fi = j_rg.SAMPLE_RATES.index(rate)
    rng = np.random.default_rng(rate)
    n = rate // 4
    x = rng.normal(0, 3000.0, (2, n))
    x[1, : n // 2] *= 1e-3  # a near-silent half
    yule, butter = j_rg._get_filters(fi)
    ref_yule = np.asarray(yule(x))
    ref = np.asarray(butter(ref_yule))
    got_yule = t_rg.iir_filter(t_rg.A_YULE[fi], t_rg.B_YULE[fi], torch.from_numpy(x))
    _close(got_yule.numpy(), ref_yule)
    got_butter = t_rg.iir_filter(t_rg.A_BUTTER[fi], t_rg.B_BUTTER[fi],
                                 torch.from_numpy(ref_yule.copy()))
    _close(got_butter.numpy(), np.asarray(butter(ref_yule)))
    before = iir_scan.launches
    got = t_rg.equal_loudness(torch.from_numpy(x), fi)
    assert iir_scan.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float64 and tuple(got.shape) == (2, n)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("rate", [44100, 96000, 8000, 192000])
def test_kernel_arithmetic_equals_iir_scan_bit_for_bit(rate):
    """fma_reference, the CUDA kernel's order of correctly rounded steps,
    gives flac_tpu's cascade exactly: the kernel can be held to it bit for
    bit on the card."""
    fi = j_rg.SAMPLE_RATES.index(rate)
    x = np.random.default_rng(rate + 1).normal(0, 3000.0, (2, 400))
    x[1] *= 1e-3
    yule, butter = j_rg._get_filters(fi)
    ref_yule = np.asarray(yule(x))
    ref = np.asarray(butter(ref_yule))
    for c in range(2):
        got_yule = t_rg.fma_reference(t_rg.A_YULE[fi], t_rg.B_YULE[fi], x[c])
        np.testing.assert_array_equal(got_yule, ref_yule[c])
        got = t_rg.fma_reference(t_rg.A_BUTTER[fi], t_rg.B_BUTTER[fi], got_yule)
        np.testing.assert_array_equal(got, ref[c])


def test_equalizer_taps_are_flac_tpus_coefficients():
    for fi in range(len(j_rg.SAMPLE_RATES)):
        taps = t_rg.equalizer_taps(fi)
        assert taps.shape == (iir_scan.N_TAPS,)
        np.testing.assert_array_equal(taps, np.concatenate([
            j_rg.B_YULE[fi], j_rg.A_YULE[fi][1:], j_rg.B_BUTTER[fi], j_rg.A_BUTTER[fi][1:]]))
    assert t_rg.SAMPLE_RATES == j_rg.SAMPLE_RATES


# (rate, bps, channels, title lengths in samples, amplitudes as a share of
# full scale): an album of titles at several loudnesses, mono, 24 bits at
# 96 kHz, and a title shorter than one 50 ms window
GAIN_CASES = {
    "16bit_stereo_album": (44100, 16, 2, [6000, 4410, 3000], [0.5, 0.05, 0.002]),
    "16bit_mono": (44100, 16, 1, [5000], [0.3]),
    "24bit_stereo_96k": (96000, 24, 2, [9600, 6000], [0.7, 0.01]),
    "short_title": (48000, 16, 2, [2000, 1000], [0.4, 0.4]),
}


@pytest.mark.parametrize("case", list(GAIN_CASES))
def test_gain_analysis_matches(case):
    rate, bps, ch, lengths, amps = GAIN_CASES[case]
    ja = j_rg.GainAnalysis(rate)
    ta = t_rg.GainAnalysis(rate, device="cpu")
    for k, (n, amp) in enumerate(zip(lengths, amps)):
        sig = _tone(n, rate, amp * (1 << (bps - 1)), bps=bps, ch=ch, seed=k)
        ja.analyze(sig, bps)
        ta.analyze(sig, bps)
        assert ta.title_peak == ja.title_peak
        assert ta.title_gain() == ja.title_gain()
        assert ta.title_peak_final == ja.title_peak_final
    assert ta.album_gain() == ja.album_gain()
    assert ta.album_peak == ja.album_peak


def test_gain_analysis_errors_match():
    for rate in (44000, 0):
        with pytest.raises(j_rg.ReplayGainError):
            j_rg.GainAnalysis(rate)
        with pytest.raises(t_rg.ReplayGainError, match="not supported"):
            t_rg.GainAnalysis(rate, device="cpu")
    sig = np.zeros((100, 3), np.int32)
    with pytest.raises(t_rg.ReplayGainError, match="mono or stereo"):
        t_rg.GainAnalysis(44100, device="cpu").analyze(sig, 16)
    assert t_rg.is_valid_sample_rate(96000) and not t_rg.is_valid_sample_rate(44000)


def _album(tmp_path, name):
    """Three small stereo titles encoded by the port (byte-identical to
    flac_tpu's encoder): with a PADDING block (tags absorbed in place),
    without one (the tempfile rewrite), and with tags and a PADDING block too
    small for the new ones. (Mono input is held in test_gain_analysis_matches:
    a mono stream here would cost flac_tpu's decoder a second compile.)"""
    specs = [(4000, 0.4, 2, [Padding(length=512)]),
             (3500, 0.05, 2, None),
             (3000, 0.2, 2, [VorbisComment(vendor_string="x", comments=["TITLE=t"]),
                             Padding(length=64)])]
    paths = []
    for k, (n, amp, ch, meta) in enumerate(specs):
        p = tmp_path / f"{name}{k}.flac"
        sig = _tone(n, 44100, amp * 32768, ch=ch, seed=10 + k)
        t_enc.encode_file(sig, 44100, 16, str(p), level=2, blocksize=1024,
                          metadata=meta, device="cpu")
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def tagged(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rg")
    src = _album(tmp, "src")
    jp, tp = [], []
    for k, p in enumerate(src):
        jp.append(str(tmp / f"j{k}.flac"))
        tp.append(str(tmp / f"t{k}.flac"))
        shutil.copy(p, jp[-1])
        shutil.copy(p, tp[-1])
    j_rg.add_replay_gain_tags(jp)
    t_rg.add_replay_gain_tags(tp, device="cpu")
    return src, jp, tp


def test_add_replay_gain_tags_bytes_match(tagged):
    src, jp, tp = tagged
    for s, a, b in zip(src, jp, tp):
        got, ref = open(b, "rb").read(), open(a, "rb").read()
        assert got == ref
        assert got != open(s, "rb").read()


def test_load_tags_match(tagged):
    src, jp, tp = tagged
    for a, b in zip(jp, tp):
        for album in (False, True):
            got = t_rg.load_tags(b, album)
            assert got is not None and got == j_rg.load_tags(a, album)
    assert t_rg.load_tags(src[1], False) is None and j_rg.load_tags(src[1], False) is None


@pytest.fixture(scope="module")
def album_ref(tagged):
    """flac_tpu's compute_replay_gain over the three source titles."""
    return j_rg.compute_replay_gain(tagged[0])


@pytest.fixture(scope="module")
def decode_once():
    """The port's decode_bytes_device, each stream decoded once in this
    module: the plain scan on the CPU takes seconds a title."""
    from flac_tpu_torch.decode import stream

    decoded, decode = {}, stream.decode_bytes_device

    def decode_cached(data, **kw):
        key = (data, tuple(sorted(kw.items())))
        if key not in decoded:
            decoded[key] = decode(data, **kw)
        return decoded[key]

    return stream, decode_cached


def test_compute_replay_gain_matches(tagged, album_ref, decode_once, monkeypatch):
    """The unrounded gains and peaks, on all three titles (4000, 3500 and
    3000 samples), filtered together as the album."""
    stream, decode_cached = decode_once
    monkeypatch.setattr(stream, "decode_bytes_device", decode_cached)
    got = t_rg.compute_replay_gain(tagged[0], device="cpu")
    assert len(got[2]) == 3
    assert got == album_ref


# the 4000-, 3500- and 3000-sample stereo titles' bytes in a launch
_TITLE_BYTES = [2 * 8 * 2 * iir_scan.padded(n) for n in (4000, 3500, 3000)]


@pytest.mark.parametrize("cap, groups", [
    (0, [[4000], [3500], [3000]]),                      # every title over the cap
    (_TITLE_BYTES[0] + _TITLE_BYTES[1], [[4000, 3500], [3000]]),
    (_TITLE_BYTES[1] + _TITLE_BYTES[2], [[4000], [3500, 3000]]),
    (None, [[4000, 3500, 3000]]),                       # LAUNCH_BYTES as it is
], ids=["each_alone", "two_then_one", "one_then_two", "one_launch"])
def test_compute_replay_gain_in_groups_matches(cap, groups, tagged, album_ref, decode_once,
                                               monkeypatch):
    """An album over LAUNCH_BYTES is filtered in consecutive groups of
    titles, each group filtered when the next title would not fit, with
    the same results."""
    calls = []
    album = t_rg.equal_loudness_album

    def counted(xs, fi):
        calls.append([int(x.shape[1]) for x in xs])
        # a group holds one title over the cap, or titles under it
        assert sum(t_rg.launch_bytes(x) for x in xs) <= max(t_rg.LAUNCH_BYTES,
                                                            t_rg.launch_bytes(xs[0]))
        return album(xs, fi)

    stream, decode_cached = decode_once
    monkeypatch.setattr(stream, "decode_bytes_device", decode_cached)
    monkeypatch.setattr(t_rg, "equal_loudness_album", counted)
    if cap is not None:
        monkeypatch.setattr(t_rg, "LAUNCH_BYTES", cap)
    assert t_rg.compute_replay_gain(tagged[0], device="cpu") == album_ref
    assert calls == groups


def test_album_helper_equals_per_title_bit_for_bit():
    """equal_loudness_album on CPU tensors is equal_loudness a title, bit
    for bit: a title shorter than one 50 ms window, a mono title duplicated
    to two channels by scaled_input, and titles of several lengths."""
    rate = 44100
    fi = t_rg.SAMPLE_RATES.index(rate)
    ga = t_rg.GainAnalysis(rate, device="cpu")
    sigs = [_tone(3000, rate, 9000, seed=20), _tone(700, rate, 4000, seed=21),
            _tone(2500, rate, 12000, ch=1, seed=22)[:, 0], _tone(1, rate, 100, seed=23),
            _tone(257, rate, 20000, seed=24)]
    xs = [ga.scaled_input(s, 16) for s in sigs]
    assert torch.equal(xs[2][0], xs[2][1])  # the mono title on both channels
    before = iir_scan.launches
    got = t_rg.equal_loudness_album(xs, fi)
    assert iir_scan.launches == before
    assert len(got) == len(xs)
    for x, y in zip(xs, got):
        ref = t_rg.equal_loudness(x, fi)
        assert y.dtype == torch.float64 and y.shape == x.shape
        assert torch.equal(y, ref)
    assert t_rg.equal_loudness_album([], fi) == []


@pytest.mark.parametrize("lengths", [[1], [31, 255], [256, 257], [3000, 1, 256],
                                     [1, 31, 255, 256, 257, 3000], [0, 5]])
def test_ragged_layout_round_trips(lengths):
    """Offsets on whole tiles, zero padding to whole tiles, segments one
    after another in title then channel order, and the split back gives
    every title exactly."""
    rng = np.random.default_rng(len(lengths))
    chans = [1 + k % 2 for k in range(len(lengths))]
    xs = [torch.from_numpy(rng.normal(0, 1000.0, (c, n))) for c, n in zip(chans, lengths)]
    buf, segs = iir_scan.pack_ragged(xs)
    layout, total = iir_scan.ragged_layout([(c, n) for c, n in zip(chans, lengths)])
    np.testing.assert_array_equal(segs, layout)
    assert buf.dtype == torch.float64 and buf.shape == (total,)
    assert total == sum(c * iir_scan.padded(n) for c, n in zip(chans, lengths))
    assert segs.shape == (sum(chans), 2) and (segs[:, 0] % iir_scan.TILE == 0).all()
    np.testing.assert_array_equal(segs[:, 1], np.repeat(lengths, chans))
    ends = segs[:, 0] + [iir_scan.padded(n) for n in segs[:, 1]]
    np.testing.assert_array_equal(segs[1:, 0], ends[:-1])  # no gap, no overlap
    covered = torch.zeros(total, dtype=torch.bool)
    for off, n in segs:
        covered[off:off + n] = True
    assert not buf[~covered].any()  # the padding is zeros
    back = iir_scan.unpack_ragged(buf, [tuple(x.shape) for x in xs])
    for x, y in zip(xs, back):
        assert y.shape == x.shape and torch.equal(y, x)
    iir_scan._check_segs(segs, total)  # the launcher takes this layout


def _no_load(name):
    raise AssertionError(f"the launcher loaded {name} before it checked its input")


@pytest.mark.parametrize("case", ["cpu", "float32", "2d", "overlap", "misaligned",
                                  "out_of_range", "negative", "no_segments", "taps"])
def test_ragged_launcher_validates_before_loading(case, monkeypatch):
    monkeypatch.setattr(iir_scan._build, "load", _no_load)
    T = iir_scan.TILE
    buf = torch.zeros(4 * T, dtype=torch.float64)
    segs = [(0, T + 1), (2 * T, 5)]
    taps = t_rg.equalizer_taps(0)
    match = {"cpu": "CUDA", "float32": "float64", "2d": "1-D", "overlap": "overlap",
             "misaligned": "multiples", "out_of_range": "leave the buffer",
             "negative": "negative", "no_segments": "pairs", "taps": "taps"}[case]
    if case == "float32":
        buf = buf.float()
    elif case == "2d":
        buf = buf.view(4, T)
    elif case == "overlap":
        segs = [(0, T + 1), (T, 5)]  # the first segment's second tile is T..2T
    elif case == "misaligned":
        segs = [(0, 5), (T + 8, 5)]
    elif case == "out_of_range":
        segs = [(0, 5), (3 * T, T + 1)]
    elif case == "negative":
        segs = [(0, -1)]
    elif case == "no_segments":
        segs = np.zeros((0, 2), np.int64)
    elif case == "taps":
        taps = taps[:-1]
    with pytest.raises(ValueError, match=match):
        iir_scan.equal_loudness_ragged(buf, segs, taps)
    with pytest.raises(ValueError, match="CUDA"):
        iir_scan.equal_loudness(torch.zeros((2, 5), dtype=torch.float64),
                                t_rg.equalizer_taps(0))


@pytest.mark.parametrize("case", ["float32", "1d", "3d"])
def test_pack_ragged_refuses_other_titles(case, monkeypatch):
    """The layout takes float64 titles [C, n] only: it would otherwise
    round or reshape them silently on their way to the kernel."""
    monkeypatch.setattr(iir_scan._build, "load", _no_load)
    x = {"float32": torch.zeros((2, 5), dtype=torch.float32),
         "1d": torch.zeros(5, dtype=torch.float64),
         "3d": torch.zeros((1, 2, 5), dtype=torch.float64)}[case]
    good = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"float64 \[C, n\]"):
        iir_scan.pack_ragged([good, x])
    with pytest.raises(ValueError, match=r"float64 \[C, n\]"):
        iir_scan.equal_loudness(x, t_rg.equalizer_taps(0))


@pytest.mark.parametrize("kw", [
    dict(gain_db=-3.2, source_bps=16, noise_shaping=0),
    dict(gain_db=4.5, source_bps=16, noise_shaping=1),
    dict(gain_db=9.0, source_bps=16, noise_shaping=2, hard_limit=True),
    dict(gain_db=1.5, source_bps=24, noise_shaping=3, target_bps=16),
    dict(gain_db=-6.0, source_bps=16, target_bps=24, hard_limit=False),
    dict(gain_db=12.0, source_bps=16, noise_shaping=1, chunk=256, peak=0.9,
         prevent_clipping=True),
    dict(gain_db=2.0, source_bps=16, dither=True, chunk=300),
])
def test_apply_gain_matches(kw):
    bps = kw["source_bps"]
    sig = _tone(1500, 44100, 0.6 * (1 << (bps - 1)), bps=bps, seed=3)
    got = t_rg.apply_gain(sig, **kw)
    ref = j_rg.apply_gain(sig, **kw)
    assert got.dtype == np.int32 and got.shape == sig.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shaping", [0, 1, 3])
def test_python_dither_matches(shaping):
    """The pure-Python mirror of the native dither (used where the native
    runtime is missing) against flac_tpu's."""
    sig = _tone(200, 44100, 20000, seed=4)
    args = (sig, 16, 16, 1.7, True, shaping != 0, shaping)
    got = t_rg._py_apply(t_rg._PyDitherState(), *args)
    ref = j_rg._py_apply(j_rg._PyDitherState(), *args)
    np.testing.assert_array_equal(got, ref)
    assert t_rg.compute_scale_factor(3.0, 1.0, 0.8, True) == \
        j_rg.compute_scale_factor(3.0, 1.0, 0.8, True)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version on the card (run on a GPU
    machine with `-m cuda`): within 1e-9 of the peak at three rates, bit
    for bit equal to fma_reference on the first 300 samples, and equal
    title gains."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(7)
    for rate in (44100, 96000, 8000):
        fi = t_rg.SAMPLE_RATES.index(rate)
        x = torch.from_numpy(rng.normal(0, 5000.0, (2, rate // 8))).cuda()
        before = iir_scan.launches
        got = t_rg.equal_loudness(x, fi)
        assert iir_scan.launches == before + 1
        ref = t_rg.iir_filter(t_rg.A_BUTTER[fi], t_rg.B_BUTTER[fi],
                              t_rg.iir_filter(t_rg.A_YULE[fi], t_rg.B_YULE[fi], x))
        _close(got.cpu().numpy(), ref.cpu().numpy())
        xc = x[:, :300].cpu().numpy()
        exact = np.stack([t_rg.fma_reference(
            t_rg.A_BUTTER[fi], t_rg.B_BUTTER[fi],
            t_rg.fma_reference(t_rg.A_YULE[fi], t_rg.B_YULE[fi], xc[c])) for c in range(2)])
        np.testing.assert_array_equal(got[:, :300].cpu().numpy(), exact)
        sig = _tone(rate // 4, rate, 12000, seed=1)
        gains = []
        for dev in ("cuda", "cpu"):
            ga = t_rg.GainAnalysis(rate, device=dev)
            ga.analyze(sig, 16)
            gains.append(ga.title_gain())
        assert gains[0] == gains[1]


@pytest.mark.cuda
def test_ragged_launch_equals_one_launch_a_title():
    """One ragged launch over titles of unequal length (run on a GPU machine
    with `-m cuda`) equals one launch a title bit for bit, and
    fma_reference on each segment's first 300 samples."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(8)
    T = iir_scan.TILE
    for rate in (44100, 96000):
        fi = t_rg.SAMPLE_RATES.index(rate)
        taps = t_rg.equalizer_taps(fi)
        xs = [torch.from_numpy(rng.normal(0, 5000.0, (2, n))).cuda()
              for n in (1, T - 1, T + 1, 3 * T, rate // 8)]
        before = iir_scan.launches
        got = t_rg.equal_loudness_album(xs, fi)
        assert iir_scan.launches == before + 1
        for x, y in zip(xs, got):
            assert torch.equal(y, iir_scan.equal_loudness(x, taps))
            xc = x[:, :300].cpu().numpy()
            exact = np.stack([t_rg.fma_reference(
                t_rg.A_BUTTER[fi], t_rg.B_BUTTER[fi],
                t_rg.fma_reference(t_rg.A_YULE[fi], t_rg.B_YULE[fi], xc[c])) for c in range(2)])
            np.testing.assert_array_equal(y[:, :300].cpu().numpy(), exact)


@pytest.mark.cuda
def test_ragged_launch_over_more_blocks_than_sms():
    """One launch over 150 stereo titles (300 blocks, so blocks share the
    H100's 132 SMs) equals one launch a title bit for bit (run on a GPU
    machine with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(9)
    fi = t_rg.SAMPLE_RATES.index(44100)
    taps = t_rg.equalizer_taps(fi)
    xs = [torch.from_numpy(rng.normal(0, 5000.0, (2, int(n)))).cuda()
          for n in rng.integers(1, 20001, size=150)]
    before = iir_scan.launches
    got = t_rg.equal_loudness_album(xs, fi)
    assert iir_scan.launches == before + 1
    for x, y in zip(xs, got):
        assert torch.equal(y, iir_scan.equal_loudness(x, taps))


@pytest.mark.cuda
def test_compute_replay_gain_in_groups_on_the_card(tagged, monkeypatch):
    """Under a lowered LAUNCH_BYTES the album is filtered on the card in
    three launches (run on a GPU machine with `-m cuda`), with the results
    of its one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = iir_scan.launches
    one = t_rg.compute_replay_gain(tagged[0], device="cuda")
    assert iir_scan.launches == before + 1
    monkeypatch.setattr(t_rg, "LAUNCH_BYTES", 0)
    before = iir_scan.launches
    assert t_rg.compute_replay_gain(tagged[0], device="cuda") == one
    assert iir_scan.launches == before + 3
