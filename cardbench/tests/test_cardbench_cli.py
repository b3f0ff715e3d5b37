"""The `flac` command cell (`cd5_cli_roundtrip`, loop `cli_encode`) and
`hires8_album_decode` on the CPU: both cells load from the real
BENCHMARK.json; a tiny album through the command at -2 comes out correct,
and not correct under the control, with one tag's gain moved by 0.02 dB,
with one peak written as full scale or with one bit flipped in a kept
stream; the sections' levels keep the tracks' peaks apart and under full
scale; the new readers read nothing from a
program without the counters; the loop's WAVE files are what the program's
reader reads."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from cardbench import harness
from cardbench.loops import cli_encode
from cardbench.metrics import _replaygain
from cardbench.tests.conftest import REPO, write_root
from flac_tpu_torch import replaygain as rg

TINY = dict(name="tiny_cd2_rg", sample_rate=44100, bits_per_sample=16, channels=2, level=2,
            blocksize=1152, verify=False, album_seconds=1.6, album_tracks=2, tracks=2,
            track_seconds=[0.6, 1.0])
MIX = dict(loop="cli_encode", files="album_sections", tracks=2, lengths="spread",
           flags=["--replay-gain", "-s", "-f"])
METRICS = ("encode_msamples_s", "compression_ratio", "idle_share.encode", "replaygain_share.cli",
           "iir_roofline.cli")


@pytest.fixture
def cli_root(tmp_path, monkeypatch):
    """A checkout with the tiny cells and `tiny_cli`, the program sent to
    the CPU."""
    root = str(tmp_path)
    spec = write_root(root)
    with open(os.path.join(root, "cardbench", "configs", "tiny_cd2_rg.json"), "w") as f:
        json.dump(TINY, f)
    with open(os.path.join(root, "cardbench", "mixes", "tiny_cli.json"), "w") as f:
        json.dump(MIX, f)
    spec["configs"].append(dict(name="tiny_cd2_rg", source="tiny",
                                file="cardbench/configs/tiny_cd2_rg.json", reduced=[], why="t"))
    spec["workloads"].append(dict(name="tiny_cli", config="tiny_cd2_rg", traffic="tiny_cli",
                                  chips=1, why="t"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append("tiny_cli")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    monkeypatch.setenv("FLAC_TPU_DEVICE", "cpu")
    return root


def _run(root, cell=None, seed=2 ** 31 + 11, **kw):
    cell = cell or harness.load_cell(root, "tiny_cli")
    return harness.run(root, cell, seed, 0.3, False, "cpu", **kw)


def test_both_new_cells_load():
    cli = harness.load_cell(REPO, "cd5_cli_roundtrip")
    assert cli.mix["loop"] == "cli_encode" and cli.config["name"] == "cd_level5_replaygain"
    assert {m["name"] for m in cli.end_to_end} == {"encode_msamples_s", "compression_ratio",
                                                   "setup_s"}
    assert {m["name"] for m in cli.per_layer} == {"idle_share.encode", "replaygain_share.cli",
                                                  "iir_roofline.cli"}
    assert cli.mix["files"] == "album_sections" and cli.files.__name__.endswith("album_sections")
    dec = harness.load_cell(REPO, "hires8_album_decode")
    assert dec.config["name"] == "hires_level8" and dec.mix["loop"] == "decode"
    assert {m["name"] for m in dec.end_to_end} == {"decode_msamples_s", "setup_s"}
    assert {m["name"] for m in dec.per_layer} == {"scan_roofline.decode", "idle_share.decode",
                                                  "host_frames.decode"}


def test_a_sound_call_is_correct(cli_root):
    r = _run(cli_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["files_checked"]["value"] >= 2
    assert r["metrics"]["encode_msamples_s"]["value"] > 0


def test_the_control_one_bit_below_is_not_correct(cli_root):
    r = _run(cli_root, control="lsb")
    assert not r["correct"]
    assert r["checks"]["samples_wrong"]["value"] > 0


def test_a_gain_moved_by_two_steps_is_not_correct(cli_root, monkeypatch):
    store = rg.store_tags

    def shifted(path, album_gain, album_peak, title_gain, title_peak):
        # each call's first file: its track gain two steps off
        if path.endswith("track01.flac"):
            title_gain += 0.02
        store(path, album_gain, album_peak, title_gain, title_peak)

    monkeypatch.setattr(rg, "store_tags", shifted)
    r = _run(cli_root)
    assert not r["correct"]
    assert r["checks"]["streaminfo_wrong"]["value"] >= 1
    assert r["checks"]["samples_wrong"]["value"] == 0


def test_a_full_scale_peak_is_not_correct(cli_root, monkeypatch):
    store = rg.store_tags

    def saturated(path, album_gain, album_peak, title_gain, title_peak):
        # each call's first file: its track peak written as full scale
        if path.endswith("track01.flac"):
            title_peak = 1.0
        store(path, album_gain, album_peak, title_gain, title_peak)

    monkeypatch.setattr(rg, "store_tags", saturated)
    r = _run(cli_root)
    assert not r["correct"]
    assert r["checks"]["streaminfo_wrong"]["value"] >= 1
    assert r["checks"]["samples_wrong"]["value"] == 0


def test_a_flipped_bit_in_a_kept_stream_is_not_correct(cli_root):
    cell = harness.load_cell(cli_root, "tiny_cli")
    check = cell.loop.check

    def flipped(run):
        _call, d = run.state["kept"][0]
        path = os.path.join(d, sorted(os.listdir(d))[0])
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0x10  # a bit inside the audio
        open(path, "wb").write(bytes(data))
        return check(run)

    cell.loop.check = flipped
    r = _run(cli_root, cell)
    assert not r["correct"]
    c = r["checks"]
    assert c["frame_errors"]["value"] + c["samples_wrong"]["value"] > 0


def test_the_new_readers_read_nothing_without_the_counters(monkeypatch):
    for name in _replaygain.NAMES:
        monkeypatch.delattr(rg, name)
        assert getattr(_replaygain.program, name) == 0
    share = harness.load_reader(os.path.join(REPO, "cardbench"), "replaygain_share.cli")
    zero = dict.fromkeys(_replaygain.NAMES, 0)
    assert share.read({"trace_counters": zero, "trace": {"window_s": 4.5}}) is None
    iir = harness.load_reader(os.path.join(REPO, "cardbench"), "iir_roofline.cli")
    notes = []
    rec = {"traced": {"units": 2, "samples": 1000}, "replaygain_windows_per_call": 4,
           "pcm_bytes": 4000, "samples": 1000, "channels": 2, "device_name": None,
           "trace": {"kernels": {}}, "trace_counters": {"iir_launches": 0}, "card": None,
           "note": notes.append}
    assert iir.read(rec) is None
    assert notes[0]["bytes"] == 1000 * 2 * 2 + 8 * 8 * 2
    assert iir.read(dict(rec, traced={"units": 0, "samples": 0})) is None


def test_the_readers_read_a_traced_record():
    share = harness.load_reader(os.path.join(REPO, "cardbench"), "replaygain_share.cli")
    c = {"replaygain_ns": 25 * 10 ** 9, "replaygain_titles": 40, "replaygain_decode_ns": 1}
    # the traced window's counters over its time: not the whole window's
    rec = {"trace_counters": c, "trace": {"window_s": 50.0},
           "window_counters": dict(c, replaygain_ns=1), "window_s": 70.0}
    assert share.read(rec) == pytest.approx(50.0)
    iir = harness.load_reader(os.path.join(REPO, "cardbench"), "iir_roofline.cli")
    rec = {"traced": {"units": 1, "samples": 10 ** 6}, "replaygain_windows_per_call": 400,
           "pcm_bytes": 4 * 10 ** 6, "samples": 10 ** 6, "channels": 2,
           "device_name": "NVIDIA H100 80GB HBM3",
           "trace": {"kernels": {"equal_loudness_kernel(double const*)": (1, 0.1)}},
           "trace_counters": {"iir_launches": 1}, "card": None, "note": lambda d: None}
    want = 100.0 * (4 * 10 ** 6 + 8 * 400 * 2) / 3.35e12 / 0.1
    assert iir.read(rec) == pytest.approx(want)


def test_the_sections_source_holds_the_albums_sections_in_the_kept_tracks():
    from types import SimpleNamespace

    import torch

    from cardbench.files import album, album_sections
    conf = SimpleNamespace(sample_rate=8000, bits=16, tracks=4, album_tracks=14,
                           album_seconds=140, track_seconds=(5, 15))
    mix = {"tracks": 4, "lengths": "spread"}
    a = album.make(torch, conf, mix, 3, "cpu")
    b = album_sections.make(torch, conf, mix, 3, "cpu")
    assert b.pcm.shape == a.pcm.shape == (40 * 8000, 2) and b.per_pass == a.per_pass == 4
    cuts = [next(b.files)[1:] for _ in range(8)]
    assert cuts[:4] == [next(a.files)[1:] for _ in range(4)]
    assert sorted(n for _, n in cuts[:4]) == sorted(n for _, n in cuts[4:])
    # 14 sections, each starting in digital silence: one every 40 s / 14
    edges = np.arange(14) * (40 * 8000 // 14)
    assert not b.pcm[edges].any() and b.pcm.any()


def test_the_sections_peak_apart_and_under_full_scale():
    from types import SimpleNamespace

    import torch

    from cardbench.files import album_sections
    conf = SimpleNamespace(sample_rate=8000, bits=16, tracks=4, album_tracks=14,
                           album_seconds=140, track_seconds=(5, 15))
    g = album_sections.gains(7, 14)
    assert sorted(g) == sorted(album_sections.gains(8, 14)) and list(g) != list(
        album_sections.gains(8, 14))
    assert 20 * np.log10(g.min()) > -6.0 and 20 * np.log10(g.max()) < -0.5
    b = album_sections.make(torch, conf, {"tracks": 4, "lengths": "spread"}, 7, "cpu")
    peaks = [int(np.abs(b.pcm[s:s + n]).max()) for _, s, n in (next(b.files) for _ in range(4))]
    assert len(set(peaks)) == 4 and max(peaks) < 32767


def test_the_wave_files_read_back_as_their_pcm(tmp_path):
    from flac_tpu_torch.containers import parse_wav
    pcm = np.random.default_rng(5).integers(-32768, 32768, (1001, 2)).astype(np.int32)
    path = str(tmp_path / "a.wav")
    cli_encode.write_wav(path, pcm, 44100, 16)
    assert os.path.getsize(path) == 44 + pcm.size * 2
    buf = parse_wav(open(path, "rb").read())
    assert (buf.sample_rate, buf.bits_per_sample, buf.channels) == (44100, 16, 2)
    assert np.array_equal(np.asarray(buf.samples), pcm)
