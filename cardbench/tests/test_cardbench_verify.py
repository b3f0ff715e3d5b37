"""The encode_verify loop on the CPU, on a tiny cell of its own written into
the tiny checkout beside the others (tiny_hires8's values with verify, the
album mix under the encode_verify loop): a sound run is correct and
reports the encode cells' metrics and verify's own; a program that writes
one frame without verifying it is not correct, through `frame_errors`; a
program without verify's counters stops in set-up."""

from __future__ import annotations

import json
import os

import pytest

from cardbench import harness
from cardbench.metrics import _verify
from cardbench.tests.conftest import TINY_CONFIGS
from flac_tpu_torch.encode import encoder as t_enc

CELL = "tiny_hires_encode_verify"
NEW_METRICS = ("verify_ms.encode", "verify_host_frames.encode",
               "verify_scan_roofline.encode")


@pytest.fixture
def verify_root(tiny_root):
    bench = os.path.join(tiny_root, "cardbench")
    with open(os.path.join(bench, "configs", "tiny_hires8_verify.json"), "w") as f:
        json.dump(dict(TINY_CONFIGS["tiny_hires8"], name="tiny_hires8_verify", verify=True), f)
    with open(os.path.join(bench, "mixes", "tiny_album_verify.json"), "w") as f:
        json.dump(dict(loop="encode_verify", files="album"), f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append(dict(name="tiny_hires8_verify", source="tiny", reduced=[],
                                why="t", file="cardbench/configs/tiny_hires8_verify.json"))
    spec["workloads"].append(dict(name=CELL, config="tiny_hires8_verify",
                                  traffic="tiny_album_verify", chips=1, why="t"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("encode_msamples_s", "compression_ratio") + NEW_METRICS:
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(spec, f)
    return tiny_root


def _run(root, trace=False):
    return harness.run(root, harness.load_cell(root, CELL), 2 ** 31 + 41, 0.5, trace, "cpu",
                       log=lambda _line: None)


def test_the_tiny_verify_cell_is_correct_and_reports_its_metrics(verify_root):
    r = _run(verify_root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"encode_msamples_s", "compression_ratio", "setup_s"}
    assert all(c["value"] == 0 for k, c in r["checks"].items() if k != "files_checked")
    t = _run(verify_root, trace=True)
    assert t["correct"], t["checks"]
    # counters on the CPU; the scan kernels' roofline needs the card's trace
    assert {"verify_ms.encode", "verify_host_frames.encode"} <= set(t["metrics"])
    assert "verify_scan_roofline.encode" not in t["metrics"]
    assert t["metrics"]["verify_ms.encode"]["value"] > 0
    # a window that closes before a file's finish() verified none on the host
    assert 0 <= t["metrics"]["verify_host_frames.encode"]["value"] <= 1e3


def test_a_frame_written_without_verify_is_not_correct(verify_root, monkeypatch):
    """The first final partial frame of the drive takes the tail's route
    without verify (the warm-up's stream has none)."""
    real, skipped = t_enc.StreamEncoder._encode_tail, []

    def skip_once(self, tail):
        if skipped:
            return real(self, tail)
        skipped.append(len(tail))
        self.verify = False
        try:
            real(self, tail)
        finally:
            self.verify = True
    monkeypatch.setattr(t_enc.StreamEncoder, "_encode_tail", skip_once)
    r = _run(verify_root)
    assert skipped
    assert not r["correct"]
    assert r["checks"]["frame_errors"]["value"] == 1
    assert r["checks"]["samples_wrong"]["value"] == 0
    assert r["checks"]["files_failed"]["value"] == 0


def test_a_program_without_verify_counters_stops_in_setup(verify_root, monkeypatch):
    """As a program that has no such counters reads: 0 throughout."""
    monkeypatch.setattr(_verify._Counters, "__getattr__", lambda self, name: 0)
    with pytest.raises(RuntimeError, match="verified no frame"):
        _run(verify_root)
