"""The `md5_wait_ms.encode` reader: nothing where the program has no MD5
worker counters or no update ran on a worker in the traced window (as the
program before the worker reads), the wait in ms a traced batch where they
are set; and a tiny traced encode cell on the CPU reports it."""

from __future__ import annotations

import os

import pytest

from cardbench import harness
from cardbench.metrics import _md5
from flac_tpu_torch.encode import encoder as t_enc

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = "md5_wait_ms.encode"


def _reader():
    return harness.load_reader(os.path.join(REPO, "cardbench"), NAME)


def _rec(updates: int, wait_ns: int, batches: int) -> dict:
    return dict(trace_counters=dict(md5_updates=updates, md5_wait_ns=wait_ns),
                traced=dict(batches=batches))


def test_a_program_without_the_counters_reads_zero_and_the_metric_nothing(monkeypatch):
    for name in _md5.NAMES:
        monkeypatch.delattr(t_enc, name)
    counters = harness.program_counters(_md5.COUNTERS)()
    assert counters == {"md5_updates": 0, "md5_wait_ns": 0}
    assert _reader().read(dict(trace_counters=counters, traced=dict(batches=12))) is None


@pytest.mark.parametrize("rec", [_rec(0, 0, 12), _rec(0, 5_000_000, 12), _rec(3, 0, 0)],
                         ids=["no-updates", "no-updates-but-a-wait", "no-batches"])
def test_nothing_to_read(rec):
    assert _reader().read(rec) is None


def test_the_wait_in_ms_a_batch():
    assert _reader().read(_rec(13, 6_000_000, 12)) == pytest.approx(0.5)
    assert _reader().read(_rec(1, 0, 4)) == 0


def test_the_proxy_reads_the_programs_counters(monkeypatch):
    monkeypatch.setattr(t_enc, "md5_updates", 7)
    monkeypatch.setattr(t_enc, "md5_wait_ns", 123)
    assert harness.program_counters(_md5.COUNTERS)() == {"md5_updates": 7, "md5_wait_ns": 123}
    with pytest.raises(AttributeError):
        _md5.program.verify_ns


def test_a_tiny_traced_encode_cell_reports_the_wait(tiny_root):
    cell = harness.load_cell(tiny_root, "tiny_album_encode")
    assert NAME in {m["name"] for m in cell.per_layer}
    r = harness.run(tiny_root, cell, 2 ** 31 + 77, 0.3, True, "cpu", log=lambda _line: None)
    assert r["correct"], r["checks"]
    assert r["metrics"][NAME]["value"] >= 0
