"""The harness on the CPU, on tiny cells of a checkout of their own: the
window closes at a unit boundary, the arithmetic of rates and
percentiles, the readers against a profiler trace recorded on the card, a
cell, mix, loop, source of files, metric and counter added as new files
and found by name, and a run that wants the card and finds none."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cardbench import harness, loops, trace
from cardbench.tests.conftest import REPO

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trace_cd5_album_encode.jsonl.gz")


def _reader(name):
    return harness.load_reader(os.path.join(REPO, "cardbench"), name)


def test_window_closes_at_the_first_unit_boundary_after_its_time():
    w = loops.Window(0.05, lambda: None)
    w.start(lambda: {"replays": 0})
    units = 0
    while w.open:
        time.sleep(0.02)
        w.add(samples=100)
        units += 1
    assert units == 3  # 0.02, 0.04: open; 0.06: the boundary that closes it
    assert w.totals["samples"] == 300 and w.totals["units"] == 3
    assert 0.05 <= w.elapsed < 0.2
    w.add(samples=100)  # after the close nothing counts
    assert w.totals["samples"] == 300


def test_rates_ratio_and_percentile_arithmetic():
    rec = dict(loop="encode", setup_s=12.5, window_s=2.0, samples=40_000_000,
               bytes=30_000_000, pcm_bytes=160_000_000,
               file_walls_ms=list(np.arange(1, 101, dtype=float)))
    assert _reader("encode_msamples_s").read(rec) == 20.0
    assert _reader("decode_msamples_s").read(rec) is None
    assert _reader("compression_ratio").read(rec) == 0.1875
    assert _reader("setup_s").read(rec) == 12.5
    assert _reader("clip_p95_ms").read(rec) == pytest.approx(95.05)
    assert _reader("clip_p95_ms").read(dict(rec, file_walls_ms=[])) is None
    assert _reader("decode_msamples_s").read(dict(rec, loop="decode")) == 20.0
    assert _reader("host_frames.decode").read(dict(rec, loop="decode", units=8,
                                                   host_frames=12)) == 1.5


def test_readers_on_a_recorded_card_trace():
    """A traced window of cd5_album_encode, recorded on an H100 (its first
    units: events of the kernels by name, the harness's spans, host
    operators), reduced and read as a run reads it."""
    events, meta = trace.load(FIXTURE)
    red = trace.reduce_events(events)
    assert 0 < red["busy_s"] <= red["window_s"]
    assert red["device_events"] > 1000
    assert sum(red["idle"].values()) == pytest.approx(red["window_s"] - red["busy_s"],
                                                      rel=1e-6)
    notes = []
    rec = dict(loop="encode", trace=red, traced=meta["traced"],
               trace_counters=meta["trace_counters"], window_counters=meta["window_counters"],
               channels=2, device_name="NVIDIA H100 80GB HBM3", card=meta["card"],
               note=notes.append)
    busy = _reader("step_busy_ms.encode").read(rec)
    events_a_batch = _reader("step_events.encode").read(rec)
    idle = _reader("idle_share.encode").read(rec)
    pack = _reader("pack_roofline.encode").read(rec)
    assert busy == pytest.approx(1e3 * red["busy_s"] / meta["traced"]["batches"])
    assert 1000 < events_a_batch < 10000
    assert 0 < idle < 100 and 0 < pack < 100
    assert notes[0]["kernel_events_seen"] == notes[0]["launch_counter"]
    assert _reader("replay_share.encode").read(rec) > 50
    assert _reader("idle_share.decode").read(rec) is None
    out = trace.breakdown(red)
    assert len(out["device_ops"]) == 10 and len(out["idle_gaps"]) <= 10
    assert out["device_ops"][0][1] >= out["device_ops"][-1][1]


def test_union_and_gaps_of_overlapping_spans():
    ev = [(trace.WINDOW, "unit", 0, 100), ("cardbench.encode.process", "unit", 10, 90),
          ("k1", "device", 5, 15), ("k2", "device", 12, 30), ("k3", "device", 50, 60),
          ("k1", "device", 95, 120)]
    red = trace.reduce_events(ev)
    assert red["busy_s"] == pytest.approx((25 + 10 + 5) / 1e9)
    assert red["kernels"]["k1"][0] == 2
    # gaps 0-5 (outside any unit), 30-50 and 60-95 (the second's midpoint,
    # 77, inside the process unit)
    assert red["idle"] == pytest.approx({"harness": 5e-9, "encode.process": 55e-9})


def _digest(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "cardbench")):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_mix_and_metric_are_found_by_name(tiny_root):
    before = _digest(tiny_root)
    bench = os.path.join(tiny_root, "cardbench")
    with open(os.path.join(bench, "mixes", "tiny_new_mix.json"), "w") as f:
        json.dump({"loop": "encode", "files": "clips", "pool_sections_seconds": [0.5],
                   "clip_seconds": [0.1, 0.2], "clip_lengths": 3}, f)
    with open(os.path.join(bench, "configs", "tiny_new_conf.json"), "w") as f:
        json.dump(dict(sample_rate=48000, bits_per_sample=16, channels=2, level=3,
                       blocksize=1152, verify=False, album_seconds=1, album_tracks=2,
                       tracks=2, track_seconds=[0.4, 0.6]), f)
    with open(os.path.join(bench, "metrics", "files_a_second.py"), "w") as f:
        f.write("def read(rec):\n    return len(rec['file_walls_ms']) / rec['window_s']\n")
    spec = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    spec["configs"].append(dict(name="tiny_new_conf", source="t", reduced=[], why="t",
                                file="cardbench/configs/tiny_new_conf.json"))
    spec["workloads"].append(dict(name="tiny_new_cell", config="tiny_new_conf",
                                  traffic="tiny_new_mix", chips=1, why="t"))
    spec["end_to_end"].append(dict(name="files_a_second", unit="1/s", better="higher",
                                   bound=0.1, source="host_clock", workloads=["tiny_new_cell"]))
    for m in spec["end_to_end"]:
        if m["name"] == "encode_msamples_s":
            m["workloads"].append("tiny_new_cell")
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    cell = harness.load_cell(tiny_root, "tiny_new_cell")
    assert cell.mix["clip_lengths"] == 3 and cell.config["level"] == 3
    assert [m["name"] for m in cell.end_to_end] == ["encode_msamples_s", "setup_s",
                                                    "files_a_second"]
    r = harness.run(tiny_root, cell, 21, 1.5, False, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"encode_msamples_s", "setup_s", "files_a_second"}
    assert r["metrics"]["files_a_second"]["value"] > 0


NEW_SOURCE = """
from types import SimpleNamespace
from cardbench import traffic


def make(torch, conf, mix, seed, device):
    n = int(mix["file_seconds"] * conf.sample_rate)
    pcm = traffic.to_host(traffic.music([n * 2], conf.sample_rate, conf.bits, seed, "album",
                                        device))

    def files():
        while True:
            yield pcm, 0, n
            yield pcm, n, n
    return SimpleNamespace(pcm=pcm, files=files(), per_pass=2)
"""

NEW_LOOP = """
import io
import time
from cardbench.loops import encode as base, run_unit

setup, result, check = base.setup, base.result, base.check


def drive(run, window):
    from flac_tpu_torch.encode.encoder import StreamEncoder
    out = run.state["files"] = []
    for pcm, start, n in run.source.files:
        if not window.open:
            break
        sink, t = io.BytesIO(), time.perf_counter()
        enc = StreamEncoder(run.conf.encoder, sink, total_samples_estimate=n,
                            device=run.device)
        run_unit(window, "encode.process", enc, sink,
                 lambda: enc.process(pcm[start:start + n]), header=True)
        run_unit(window, "encode.finish", enc, sink, enc.finish)
        out.append(dict(start=start, n=n, data=sink.getvalue(), error=None, in_window=True,
                        wall_s=time.perf_counter() - t))
"""


def test_a_new_loop_source_and_counter_are_found_by_name(tiny_root):
    before = _digest(tiny_root)
    bench = os.path.join(tiny_root, "cardbench")
    with open(os.path.join(bench, "files", "tiny_two_files.py"), "w") as f:
        f.write(NEW_SOURCE)
    with open(os.path.join(bench, "loops", "tiny_whole_file.py"), "w") as f:
        f.write(NEW_LOOP)
    with open(os.path.join(bench, "mixes", "tiny_whole.json"), "w") as f:
        json.dump({"loop": "tiny_whole_file", "files": "tiny_two_files",
                   "file_seconds": 0.2}, f)
    with open(os.path.join(bench, "metrics", "whole_files.py"), "w") as f:
        f.write("COUNTERS = {'pack_calls': ['flac_tpu_torch.kernels.pack_words:launches']}\n"
                "def read(rec):\n    return len(rec['file_walls_ms'])\n")
    spec = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    spec["workloads"].append(dict(name="tiny_whole_cell", config="tiny_cd5",
                                  traffic="tiny_whole", chips=1, why="t"))
    spec["end_to_end"].append(dict(name="whole_files", unit="files", better="higher",
                                   bound=0.1, source="host_clock",
                                   workloads=["tiny_whole_cell"]))
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    cell = harness.load_cell(tiny_root, "tiny_whole_cell")
    assert cell.counters == {"pack_calls": ["flac_tpu_torch.kernels.pack_words:launches"]}
    r = harness.run(tiny_root, cell, 2 ** 33 + 5, 0.5, False, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"whole_files", "setup_s"}
    assert r["metrics"]["whole_files"]["value"] >= 1


def test_counters_are_read_by_the_paths_their_readers_name(monkeypatch):
    from flac_tpu_torch.kernels import pack_words
    read = harness.program_counters(
        {"pack": ["flac_tpu_torch.kernels.pack_words:launches",
                  "flac_tpu_torch.kernels.pack_words:pack_words_multi.launches"]})
    monkeypatch.setattr(pack_words, "launches", 5)
    monkeypatch.setattr(pack_words.pack_words_multi, "launches", 2)
    assert read() == {"pack": 7}
    assert harness.program_counters({})() == {}
    with pytest.raises(harness.SpecError):
        harness.program_counters({"x": ["flac_tpu.graphs:replays"]})


def test_a_missing_loop_or_source_is_refused(tiny_root):
    bench = os.path.join(tiny_root, "cardbench")
    for i, mix in enumerate(({"loop": "no_such_loop", "files": "album"},
                             {"loop": "encode", "files": "no_such_files"})):
        with open(os.path.join(bench, "mixes", f"tiny_bad{i}.json"), "w") as f:
            json.dump(mix, f)
    spec = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    spec["workloads"] += [dict(name=f"tiny_bad_cell{i}", config="tiny_cd5",
                               traffic=f"tiny_bad{i}", chips=1, why="t") for i in range(2)]
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for i in range(2):
        with pytest.raises(harness.SpecError):
            harness.load_cell(tiny_root, f"tiny_bad_cell{i}")


@pytest.mark.parametrize("cell,expect", [
    ("tiny_album_encode", {"encode_msamples_s", "compression_ratio", "setup_s"}),
    ("tiny_clips_encode", {"encode_msamples_s", "clip_p95_ms", "compression_ratio",
                           "setup_s"}),
    ("tiny_album_decode", {"decode_msamples_s", "setup_s"}),
])
def test_tiny_cells_report_their_metrics_and_are_correct(tiny_root, cell, expect):
    r = harness.run(tiny_root, harness.load_cell(tiny_root, cell), 2 ** 31 + 99, 1.5, False,
                    "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == expect
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["limit"] == 0 for k, c in r["checks"].items() if k != "files_checked")
    assert r["checks"]["files_checked"]["value"] >= r["checks"]["files_checked"]["least"]


def test_a_traced_run_reports_per_layer_metrics_only(tiny_root, tmp_path):
    notes = []
    cell = harness.load_cell(tiny_root, "tiny_album_encode")
    dumped = str(tmp_path / "t.jsonl.gz")
    r = harness.run(tiny_root, cell, 5, 0.3, True, "cpu", log=notes.append,
                    dump_trace=dumped)
    events, meta = trace.load(dumped)
    assert trace.reduce_events(events)["window_s"] == r["device"]["window_s"]
    assert meta["traced"]["units"] >= 1
    assert r["correct"]
    # no device in a CPU run: the readers of device traces find nothing
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert not any(n in r["metrics"] for n in ("step_busy_ms.encode", "pack_roofline.encode"))
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert "breakdown" in r and list(r)[-1] == "checks"


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "cardbench", "run.py"),
                        "--workload", "cd5_album_encode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_main_refuses_the_cpu_even_when_torch_says_no_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "cd5_clips_encode", "--seed", "3", "--seconds", "1",
                         "--trace", "1"], time.perf_counter()) != 0
    assert capsys.readouterr().out == ""


def test_an_unknown_workload_fails(capsys):
    assert harness.main(["--workload", "no_such_cell", "--seed", "3", "--seconds", "1"],
                        time.perf_counter()) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tiny_root):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in ("tiny_album_encode", "tiny_album_decode"):
        r = harness.run(tiny_root, harness.load_cell(tiny_root, cell), 17, 1.0, False, "cuda")
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu"
