"""The port's `metaflac` against flac_tpu's, on the CPU.

Each case runs the same command lines through `flac_tpu.cli.metaflac.main`
on one copy of a small stream and through `flac_tpu_torch.cli.metaflac.main`
on another, with FLAC_TPU_DEVICE=cpu, and requires equal exit codes,
standard output and error, file bytes and exported files. Like flac_tpu,
`--add-replay-gain` tags each file as an album of its own (ROADMAP queue 3).
"""

from __future__ import annotations

import struct
import zlib

import pytest
import torch

from conftest import make_signal
from flac_tpu.cli import metaflac as j_mf
from flac_tpu_torch.cli import metaflac as t_mf
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.metadata import Padding, VorbisComment

# 15 CD frames of 588 samples: a CD-DA lead-out for the cuesheet cases
SIG = make_signal(588 * 15, 2, 16, kind="sine", seed=31)

CUE = ('FILE "x.wav" WAVE\n  TRACK 01 AUDIO\n    INDEX 01 00:00:00\n'
       '  TRACK 02 AUDIO\n    INDEX 00 00:00:03\n    INDEX 01 00:00:05\n')


def _png_bytes(w=8, h=8):
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))
    return (b"\x89PNG\x0d\x0a\x1a\x0a" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", b"\x00") + chunk(b"IEND", b""))


# name -> command lines, each run on the file in turn; {d} is the case's
# directory for the files a command reads or writes
CASES = {
    "list": [["--list"], ["--list", "--block-type=STREAMINFO,PADDING"],
             ["--list", "--except-block-type=PADDING", "--with-filename"],
             ["--show-md5sum", "--show-total-samples", "--show-bps"]],
    "tags": [["--set-tag=ARTIST=abc", "--set-tag=TITLE=x y"], ["--show-tag=ARTIST"],
             ["--remove-tag=ARTIST"], ["--export-tags-to={d}/tags.txt"],
             ["--remove-all-tags", "--import-tags-from={d}/tags.txt"], ["--list"]],
    "picture": [["--import-picture-from=3|image/png|cover||{d}/p.png"],
                ["--export-picture-to={d}/out.png"], ["--list", "--block-type=PICTURE"]],
    "seekpoints": [["--add-seekpoint=4x", "--add-seekpoint=1000"],
                   ["--list", "--block-type=SEEKTABLE"]],
    "cuesheet": [["--import-cuesheet-from={d}/in.cue"], ["--export-cuesheet-to={d}/out.cue"],
                 ["--list", "--block-type=CUESHEET,SEEKTABLE"]],
    "padding": [["--add-padding=100", "--add-padding=50"], ["--merge-padding"],
                ["--sort-padding"], ["--dont-use-padding", "--set-tag=A=b"],
                ["--block-type=PADDING", "--remove"], ["--list"]],
    "replay_gain": [["--add-replay-gain"], ["--list", "--block-type=VORBIS_COMMENT"],
                    ["--remove-replay-gain"], ["--list"]],
    "errors": [["--export-picture-to={d}/none.png"], ["--bogus-option"],
               ["--export-cuesheet-to=-"]],
}


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    p = tmp_path_factory.mktemp("mf") / "src.flac"
    t_enc.encode_file(SIG, 44100, 16, str(p), level=2, blocksize=1024,
                      metadata=[VorbisComment(vendor_string="v", comments=["TITLE=t"]),
                                Padding(length=256)], device="cpu")
    return p.read_bytes()


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("case", list(CASES))
def test_metaflac_matches(tmp_path, stream, case, monkeypatch, capsys):
    monkeypatch.setenv("FLAC_TPU_DEVICE", "cpu")
    dirs = {}
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        (d / "x.flac").write_bytes(stream)
        (d / "p.png").write_bytes(_png_bytes())
        (d / "in.cue").write_text(CUE)
        dirs[side] = d
    edited, outputs = False, ""
    for argv in CASES[case]:
        runs = {}
        for side, main in (("j", j_mf.main), ("t", t_mf.main)):
            d = dirs[side]
            args = [a.format(d=d) for a in argv] + [str(d / "x.flac")]
            rc, out, err = _run(main, args, capsys)
            runs[side] = (rc, out.replace(str(d), "{d}"), err.replace(str(d), "{d}"))
        assert runs["t"] == runs["j"], argv
        outputs += runs["t"][1] + runs["t"][2]
        got = (dirs["t"] / "x.flac").read_bytes()
        assert got == (dirs["j"] / "x.flac").read_bytes(), argv
        edited |= got != stream
    names = sorted(p.name for p in dirs["j"].iterdir())
    assert names == sorted(p.name for p in dirs["t"].iterdir())
    for name in names:
        assert (dirs["t"] / name).read_bytes() == (dirs["j"] / name).read_bytes(), name
    assert edited == (case not in ("list", "errors"))
    if case == "replay_gain":
        assert "REPLAYGAIN_TRACK_GAIN=" in outputs


def test_metaflac_device_rule(tmp_path, stream, monkeypatch):
    """Without FLAC_TPU_DEVICE the device is CUDA, which raises without a
    GPU; FLAC_TPU_DEVICE names the torch device."""
    p = tmp_path / "x.flac"
    p.write_bytes(stream)
    monkeypatch.delenv("FLAC_TPU_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_mf.main(["--list", str(p)])
    monkeypatch.setenv("FLAC_TPU_DEVICE", "cpu")
    assert t_mf.main(["--show-sample-rate", str(p)]) == 0
    assert p.read_bytes() == stream
