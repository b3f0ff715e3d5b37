"""`flac --replay-gain` through the port's command on the CPU, held against
the benchmark's plain references: two seeded WAVE titles of about 3 s
encoded at -2 and tagged as one album by `flac_tpu_torch.cli.flac.main`;
the tags against `cardbench/reference/replaygain.py` (the same gains, a
0.01 dB histogram step each, and every other tag the same string), each
stream decoded by
`cardbench/reference/flac.py` against its input, the reference's
coefficient tables against the port's, and the spans and counters of the
command and of the ReplayGain module recorded once a file, title or launch."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cardbench import traffic
from cardbench.loops.cli_encode import write_wav
from cardbench.reference import flac as ref
from cardbench.reference import replaygain as rgref
from cardbench.reference.md5 import flac_md5
from flac_tpu_torch import replaygain as rg
from flac_tpu_torch import trace
from flac_tpu_torch.cli import flac
from flac_tpu_torch.replaygain import coefficients

torch.set_num_threads(1)

RATE, BITS = 44100, 16
LENGTHS = (3 * RATE + 1234, 3 * RATE - 2222)
COUNTERS = ("replaygain_ns", "replaygain_titles", "replaygain_decode_ns")


@pytest.fixture(scope="module")
def album(tmp_path_factory):
    """The titles, the files the command wrote, its return code, the spans
    it recorded and its counters' growth."""
    d = tmp_path_factory.mktemp("album")
    pcm = traffic.to_host(traffic.music(LENGTHS, RATE, BITS, 2 ** 32 + 23, "album", "cpu"))
    titles = [pcm[:LENGTHS[0]], pcm[LENGTHS[0]:]]
    wavs = []
    for k, t in enumerate(titles):
        wavs.append(str(d / f"t{k}.wav"))
        write_wav(wavs[-1], t, RATE, BITS)
    before = {k: getattr(rg, k) for k in COUNTERS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAC_TPU_DEVICE", "cpu")
        trace.start()
        try:
            rc = flac.main(["-2", "--replay-gain", "-s", "-f", *wavs])
        finally:
            spans = trace.stop()
    grew = {k: getattr(rg, k) - before[k] for k in COUNTERS}
    outs = [w[:-4] + ".flac" for w in wavs]
    data = [open(p, "rb").read() for p in outs]
    return titles, data, rc, spans, grew


def test_the_tags_are_the_plain_references(album):
    titles, data, rc, _spans, _grew = album
    assert rc == 0
    want = rgref.tags(rgref.analyse(titles, BITS, RATE))
    for d, w in zip(data, want):
        got = rgref.replaygain_tags(d)
        assert set(got) == set(rgref.TAGS)
        assert rgref.mismatches(got, w) == 0, (got, w)
        assert got["REPLAYGAIN_TRACK_PEAK"] == w["REPLAYGAIN_TRACK_PEAK"]


def test_each_stream_decodes_to_its_input(album):
    titles, data, _rc, _spans, _grew = album
    for t, dec in zip(titles, ref.decode_streams(data, "cpu")):
        assert dec.errors == []
        assert np.array_equal(dec.pcm, t)
        assert dec.streaminfo.total_samples == len(t)
        assert dec.streaminfo.md5 == flac_md5(t, BITS)


@pytest.mark.parametrize("index", range(len(coefficients.SAMPLE_RATES)))
def test_the_references_coefficient_tables_are_the_ports(index):
    rate = coefficients.SAMPLE_RATES[index]
    yule_b, yule_a, butter_b, butter_a = rgref.FILTERS[rate]
    assert list(yule_b) == coefficients.B_YULE[index]
    assert list(yule_a) == coefficients.A_YULE[index]
    assert list(butter_b) == coefficients.B_BUTTER[index]
    assert list(butter_a) == coefficients.A_BUTTER[index]
    assert set(rgref.FILTERS) == set(coefficients.SAMPLE_RATES)


@pytest.mark.parametrize("rate", [44100, 96000])
def test_the_references_blocked_filter_is_the_ports_plain_filter(rate):
    g = torch.Generator().manual_seed(rate)
    n = 2 * rgref.BLOCK + 777
    x = torch.randint(-30000, 30000, (2, n), generator=g).double()
    yule_b, yule_a, butter_b, butter_a = rgref.FILTERS[rate]
    want = rg.equal_loudness(x, coefficients.SAMPLE_RATES.index(rate))
    got = rgref.iir(butter_b, butter_a, rgref.iir(yule_b, yule_a, x))
    assert torch.allclose(got, want, rtol=0, atol=1e-10 * float(want.abs().max()))


def test_the_spans_come_once_a_file_title_or_launch(album):
    _titles, _data, _rc, spans, _grew = album
    names = [s[0] for s in spans]
    once = {"cli.encode": 2, "cli.replaygain": 1, "replaygain.decode": 2,
            "replaygain.filter": 1, "replaygain.copy_back": 2, "replaygain.windows": 2,
            "replaygain.tags": 2}
    assert {k: names.count(k) for k in once} == once
    by_id = {s[1]: s for s in spans}
    top = next(s for s in spans if s[0] == "cli.replaygain")
    for s in spans:
        if s[0].startswith("replaygain."):
            assert by_id[s[2]] is top
        if s[0] == "decoder.call":
            assert by_id[s[2]][0] == "replaygain.decode"
        if s[0] == "encoder.open":
            assert by_id[s[2]][0] == "cli.encode"
    assert max(s[6] for s in spans if s[0] == "cli.encode") <= top[5]


def test_the_counters_grow_by_the_album(album):
    _titles, _data, _rc, spans, grew = album
    assert grew["replaygain_titles"] == 2
    top = next(s for s in spans if s[0] == "cli.replaygain")
    decodes = sum(s[6] - s[5] for s in spans if s[0] == "replaygain.decode")
    assert 0 < grew["replaygain_decode_ns"] < grew["replaygain_ns"] <= top[6] - top[5]
    assert grew["replaygain_decode_ns"] <= decodes + 10 ** 6


@pytest.mark.parametrize("tag,value,tolerance,wrong", [
    ("REPLAYGAIN_TRACK_GAIN", "-7.00 dB", None, 0), ("REPLAYGAIN_TRACK_GAIN", "-7.01 dB", None, 1),
    ("REPLAYGAIN_TRACK_GAIN", "-7.01 dB", 0.01, 0), ("REPLAYGAIN_TRACK_GAIN", "-6.99 dB", 0.01, 0),
    ("REPLAYGAIN_TRACK_GAIN", "-7.02 dB", 0.01, 1), ("REPLAYGAIN_ALBUM_GAIN", "-6.98 dB", 0.01, 1),
    ("REPLAYGAIN_ALBUM_GAIN", "-7.00", None, 1),
    ("REPLAYGAIN_TRACK_PEAK", "0.50000001", None, 1),
    ("REPLAYGAIN_REFERENCE_LOUDNESS", "89 dB", None, 1), ("REPLAYGAIN_ALBUM_PEAK", None, None, 1)])
def test_the_tag_comparison(tag, value, tolerance, wrong):
    want = {"REPLAYGAIN_REFERENCE_LOUDNESS": "89.0 dB", "REPLAYGAIN_TRACK_GAIN": "-7.00 dB",
            "REPLAYGAIN_TRACK_PEAK": "0.50000000", "REPLAYGAIN_ALBUM_GAIN": "-7.00 dB",
            "REPLAYGAIN_ALBUM_PEAK": "0.50000000"}
    got = dict(want)
    if value is None:
        del got[tag]
    else:
        got[tag] = value
    kw = {} if tolerance is None else {"tolerance_db": tolerance}
    assert rgref.mismatches(got, want, **kw) == wrong


def test_gain_steps():
    assert rgref.gain_steps("-7.02 dB", "-7.00 dB") == 2
    assert rgref.gain_steps("+0.01 dB", "-0.01 dB") == 2
    assert rgref.gain_steps("-7.00", "-7.00 dB") == float("inf")


def test_the_off_recorder_keeps_its_shared_no_op():
    trace.stop()
    assert trace.span("cli.encode") is trace.span("replaygain.filter")
