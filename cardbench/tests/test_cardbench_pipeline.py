"""The `pipelined_share.encode` reader: nothing where the program has no
pipeline counters or launched no batch in the traced window (as the
program before the pipeline reads), the share of batches launched behind
another where they are set; and a tiny traced encode cell on the CPU,
where the depth is 1, reports 0."""

from __future__ import annotations

import os

import pytest

from cardbench import harness
from cardbench.metrics import _pipeline
from flac_tpu_torch.encode import encoder as t_enc

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = "pipelined_share.encode"


def _reader():
    return harness.load_reader(os.path.join(REPO, "cardbench"), NAME)


def _rec(batches: int, pipelined: int) -> dict:
    return dict(trace_counters=dict(pipeline_batches=batches, pipelined_batches=pipelined,
                                    pipeline_wait_ns=0))


def test_a_program_without_the_counters_reads_zero_and_the_metric_nothing(monkeypatch):
    for name in _pipeline.NAMES:
        monkeypatch.delattr(t_enc, name)
    counters = harness.program_counters(_pipeline.COUNTERS)()
    assert counters == dict.fromkeys(_pipeline.NAMES, 0)
    assert _reader().read(dict(trace_counters=counters)) is None


def test_the_share_of_batches_launched_behind_another():
    assert _reader().read(_rec(0, 0)) is None
    assert _reader().read(_rec(40, 39)) == pytest.approx(97.5)
    assert _reader().read(_rec(1, 0)) == 0


def test_the_proxy_reads_the_programs_counters(monkeypatch):
    monkeypatch.setattr(t_enc, "pipeline_batches", 7)
    monkeypatch.setattr(t_enc, "pipelined_batches", 5)
    monkeypatch.setattr(t_enc, "pipeline_wait_ns", 123)
    assert harness.program_counters(_pipeline.COUNTERS)() == dict(
        pipeline_batches=7, pipelined_batches=5, pipeline_wait_ns=123)
    with pytest.raises(AttributeError):
        _pipeline.program.md5_wait_ns


def test_a_tiny_traced_encode_cell_reports_depth_one_on_the_cpu(tiny_root):
    cell = harness.load_cell(tiny_root, "tiny_album_encode")
    assert NAME in {m["name"] for m in cell.per_layer}
    r = harness.run(tiny_root, cell, 2 ** 31 + 78, 0.3, True, "cpu", log=lambda _line: None)
    assert r["correct"], r["checks"]
    assert r["metrics"][NAME]["value"] == 0
