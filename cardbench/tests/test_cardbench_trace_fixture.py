"""The recorded fixture's reduction, pinned: the device's busy time, its
events and time by kernel, the idle time by unit and the breakdown that
the per-layer readers and the result line read from a traced window."""

from __future__ import annotations

import hashlib
import json
import os

from cardbench import trace

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def test_the_fixture_reduces_to_its_pinned_numbers():
    events, _meta = trace.load(os.path.join(FIXTURES, "trace_cd5_album_encode.jsonl.gz"))
    red = trace.reduce_events(events)
    assert red["window_s"] == 0.171370038
    assert red["busy_s"] == 0.043429883
    assert red["device_events"] == 26032
    assert len(red["kernels"]) == 147
    assert hashlib.sha256(json.dumps(red["kernels"], sort_keys=True).encode()).hexdigest() == \
        "1fa1373b916790a9e5206a00aa6d0ef250b6653583f40aa6d1c1323160d3dc23"
    assert red["idle"] == {"encode.process": 0.12794015499999273}
    assert trace.breakdown(red)["idle_gaps"] == [["encode.process", 0.12794015499999273]]
