"""flac_tpu_torch.trace, the port's span recorder, on the CPU: the span
tree of a stream encode and of a decode call, the MD5 workers' spans and
their causes, nothing recorded while the recorder is off, the same bytes and
PCM with it on and off, and the cap on the spans kept; on the card, the
spans and torch.profiler's device events on one clock (`-m cuda`)."""

from __future__ import annotations

import io
import json
import threading

import numpy as np
import pytest
import torch

from flac_tpu_torch import trace
from flac_tpu_torch.decode.stream import decode_bytes_device
from flac_tpu_torch.encode import frame_encoder
from flac_tpu_torch.encode.encoder import StreamEncoder
from flac_tpu_torch.encode.frame_encoder import EncoderConfig
from flac_tpu_torch.graphs import GraphedStep

torch.set_num_threads(1)

BS, B = 256, 4
N = 3 * B * BS + 100  # three full batches and a partial frame of 100


def _pcm() -> np.ndarray:
    rng = np.random.default_rng(17)
    t = np.arange(N)
    left = 3000 * np.sin(t / 7.0) + rng.integers(-40, 40, N)
    return np.stack([left, 2000 * np.sin(t / 11.0)], axis=1).astype(np.int32)


def _encode(pcm: np.ndarray) -> bytes:
    cfg = EncoderConfig.from_level(5, 2, 16, 44100, blocksize=BS)
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=B, total_samples_estimate=N, device="cpu")
    enc.process(pcm)
    enc.finish()
    return sink.getvalue()


def _tree(spans: list) -> list:
    """The spans as (depth, name), in the order they began."""
    by_id = {s[1]: s for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: (s[5], s[1])):
        depth, p = 0, s[2]
        while p in by_id:
            depth, p = depth + 1, by_id[p][2]
        out.append((depth, s[0]))
    return out


@pytest.fixture
def recorder():
    trace.stop()
    yield trace
    trace.stop()


@pytest.fixture(scope="module")
def encoded():
    """The stream encoded with the recorder on and off, and the spans."""
    pcm = _pcm()
    frame_encoder._graphed_dense.cache_clear()  # a build at open and at the tail
    frame_encoder._graphed_tail.cache_clear()
    trace.start()
    try:
        on = _encode(pcm)
    finally:
        spans = trace.stop()
    return pcm, on, _encode(pcm), spans


def test_encode_records_the_span_tree(encoded):
    _pcm_in, on, off, spans = encoded
    assert on == off
    # the bit counts back, then the compacted stream's prefix
    batch = [(1, "encoder.batch"), (2, "step.eager"), (2, "encoder.copy_back"),
             (2, "encoder.copy_back"), (2, "encoder.emit")]
    main = [s for s in spans if s[0] != "encoder.md5"]
    assert _tree(main) == [
        (0, "encoder.open"), (1, "step.build"),
        (0, "encoder.process"), (1, "encoder.buffer"), *batch, *batch, *batch,
        (1, "encoder.md5_wait"),
        (0, "encoder.finish"),
        (1, "encoder.tail"), (2, "step.build"), (2, "step.eager"), (2, "encoder.copy_back"),
        (2, "encoder.emit"), (1, "encoder.md5_wait"),
        (1, "encoder.streaminfo")]
    assert len({s[3] for s in spans}) == 1 and spans[0][3] > 0
    assert len({s[4] for s in main}) == 1
    # one batch span a step call, each holding that call's span
    by_id = {s[1]: s for s in spans}
    steps = [s for s in spans if s[0] == "step.eager"]
    assert len(steps) == 4
    assert sorted(by_id[s[2]][0] for s in steps) == ["encoder.batch"] * 3 + ["encoder.tail"]
    for s in main:
        assert s[5] <= s[6]
        if s[2]:
            parent = by_id[s[2]]
            assert parent[5] <= s[5] and s[6] <= parent[6]
    # the MD5 on its worker thread: an update a chunk, then the tail's, each
    # caused by the span that handed it over and done before the wait after it
    md5 = sorted((s for s in spans if s[0] == "encoder.md5"), key=lambda s: s[5])
    assert [by_id[s[2]][0] for s in md5] == ["encoder.process"] * 3 + ["encoder.finish"]
    assert len({s[4] for s in md5}) == 1 and md5[0][4] != main[0][4]  # one worker
    waits = sorted((s for s in spans if s[0] == "encoder.md5_wait"), key=lambda s: s[5])
    for s in md5:
        assert s[5] >= by_id[s[2]][5]
        assert s[6] <= next(w for w in waits if w[2] == s[2])[6]


def test_decode_records_the_span_tree_and_the_md5_worker(encoded, recorder):
    pcm, data, _off, _spans = encoded
    off = decode_bytes_device(data, device="cpu", max_lpc_order=12)[0]
    recorder.start()
    got, _si, info = decode_bytes_device(data, device="cpu", max_lpc_order=12)
    spans = recorder.stop()
    assert np.array_equal(got, pcm) and np.array_equal(off, pcm)
    assert info["host_frames"] == 1
    call = [s for s in spans if s[0] == "decoder.call"]
    assert len(call) == 1 and call[0][2] == 0
    call = call[0]
    tree = _tree(spans)
    assert tree[0] == (0, "decoder.call")
    assert {d for d, _ in tree[1:]} == {1}
    assert [n for _, n in tree if n != "decoder.md5"] == [
        "decoder.call", "decoder.open", "decoder.upload", "decoder.index", "decoder.build",
        "decoder.batch", "decoder.copy_back", "decoder.crc16", "decoder.host_frames",
        "decoder.md5_wait", "decoder.assemble"]
    assert all(s[3] == call[3] for s in spans)
    md5 = [s for s in spans if s[0] == "decoder.md5"]
    assert len(md5) == 2  # the device frames, then the final partial frame
    for s in md5:
        assert s[4] != call[4] and s[2] == call[1]
    wait = next(s for s in spans if s[0] == "decoder.md5_wait")
    assert max(s[6] for s in md5) <= wait[6]


def test_off_records_nothing(recorder):
    assert recorder.span("a") is recorder.span("b")
    assert recorder.current() is None
    _encode(_pcm()[: B * BS + 10])
    recorder.start()
    assert recorder.stop() == []


def test_a_worker_span_keeps_its_cause(recorder):
    def work(cause):
        with recorder.span("work", parent=cause):
            pass

    recorder.start()
    with recorder.span("outer", stream=7):
        t = threading.Thread(target=work, args=(recorder.current(),))
        t.start()
        t.join(10)
        assert not t.is_alive()
    with recorder.span("lone"):
        pass
    spans = {s[0]: s for s in recorder.stop()}
    outer, work, lone = spans["outer"], spans["work"], spans["lone"]
    assert outer[2] == 0 and outer[3] == 7
    assert work[2] == outer[1] and work[3] == 7 and work[4] != outer[4]
    assert lone[2] == 0 and lone[3] == 0


def test_a_span_open_at_stop_is_left_out(recorder):
    recorder.start()
    with recorder.span("open"):
        kept = recorder.stop()
    assert kept == []
    recorder.start()
    assert recorder.stop() == []


def test_the_cap_counts_what_it_drops(recorder, monkeypatch):
    assert trace.MAX_SPANS == 1_000_000
    monkeypatch.setattr(trace, "MAX_SPANS", 5)
    recorder.start()
    for i in range(8):
        with recorder.span(f"s{i}"):
            pass
    spans = recorder.stop()
    assert [s[0] for s in spans] == [f"s{i}" for i in range(5)]
    assert recorder.dropped == 3
    recorder.start()
    assert recorder.dropped == 0


def test_a_graphed_step_on_the_cpu_is_one_eager_span(recorder):
    step = GraphedStep(lambda x: x + 1, "t", "cpu")
    recorder.start()
    assert int(step(torch.tensor(1))) == 2
    assert [s[0] for s in recorder.stop()] == ["step.eager"]


@pytest.mark.cuda
def test_cuda_spans_and_profiler_device_events_share_one_clock(recorder):
    """A span around a spinning kernel and a synchronize holds the kernel's
    device event, within 50 us at both ends. The host's launch and
    synchronize add to the lead and the trail of each spin, and an offset
    of the clocks adds to one and takes from the other in every spin: so no
    spin falls outside its span by 50 us, and the closest spin is within
    50 us at both ends. The first two spins after the profiler starts wait
    on its own start-up, and are left out of the latter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device's clock is the one under test")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    recorder.start()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            with recorder.span("clock.spin"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
    spans = sorted((s for s in recorder.stop() if s[0] == "clock.spin"), key=lambda s: s[5])
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda and not e.is_user_annotation()
                     and "spin" in e.name())
    assert len(spans) == len(kernels) == 8
    lead = [k[0] - s[5] for s, k in zip(spans, kernels)]
    trail = [s[6] - k[1] for s, k in zip(spans, kernels)]
    print(json.dumps({"clock_lead_ns": lead, "clock_trail_ns": trail,
                      "kernel_ns": [k[1] - k[0] for k in kernels]}))
    assert min(lead) > -50_000 and min(trail) > -50_000
    assert min(lead[2:]) < 50_000 and min(trail[2:]) < 50_000
