"""The stream encoder's two-deep pipeline, on the CPU with the depth set to
2 (on the CPU it is 1; on CUDA 2): the stream, its STREAMINFO (MD5
included) and its seektable are those of depth 1 and of flac_tpu's
encode_file, whatever the process() sizes, with and without verify; a
stream of one batch, an empty stream and one of whole frames alone; a
verify mismatch in the batch carried out of process() raises VerifyError
by finish(); the pipeline's counters count the batches launched and those
launched behind another. The CUDA half (staging, the card's bytes) is
tests/test_torch_pipeline_cuda.py.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode.encoder import StreamEncoder, VerifyError
from flac_tpu_torch.encode.frame_encoder import EncoderConfig

torch.set_num_threads(1)

BS, B = 256, 4
TAIL = 100
N = 11 * BS + TAIL  # batches of 4, 4 and 3 frames in one process() call, and a tail
LEVEL = 2  # flac_tpu's build at -2 (no LPC) compiles in a few seconds
SEEKPOINTS = [0, 700, 5 * BS, N - 1]
CFG = EncoderConfig.from_level(LEVEL, 2, 16, 44100, blocksize=BS)


def _signal(n: int) -> np.ndarray:
    rng = np.random.default_rng(22)
    t = np.arange(n)[:, None]
    x = 12000 * np.sin(2 * np.pi * (331 + 97 * np.arange(2)) * t / 44100)
    return (x + rng.normal(0, 150, x.shape)).astype(np.int32)


def _encoder(sink, n: int, depth: int, **kw) -> StreamEncoder:
    enc = StreamEncoder(CFG, sink, batch_frames=B, total_samples_estimate=n,
                        device="cpu", **kw)
    enc.pipeline_depth = depth
    return enc


def _stream(pcm: np.ndarray, size: int | None, depth: int, **kw) -> bytes:
    sink = io.BytesIO()
    enc = _encoder(sink, len(pcm), depth, **kw)
    size = size or max(len(pcm), 1)
    for s in range(0, len(pcm), size):
        enc.process(pcm[s : s + size])
    enc.finish()
    return sink.getvalue()


def _flac_tpu(tmp_path, pcm: np.ndarray, seekpoints) -> bytes:
    from flac_tpu.encode import encoder as j_enc

    path = tmp_path / "j.flac"
    j_enc.encode_file(pcm, 44100, 16, str(path), level=LEVEL, blocksize=BS,
                      batch_frames=B, seekpoints=seekpoints)
    return path.read_bytes()


@pytest.mark.parametrize("size,verify,seekpoints", [
    (BS, False, None),
    (3 * BS, False, None),
    (64 * BS, False, None),
    (1000, False, None),
    (BS, False, SEEKPOINTS),
    (3 * BS, False, SEEKPOINTS),
    (64 * BS, False, SEEKPOINTS),
    (1000, False, SEEKPOINTS),
    (64 * BS, True, SEEKPOINTS),
], ids=["1-frame", "3-frames", "64-frames", "1000-samples", "1-frame-seektable",
        "3-frames-seektable", "64-frames-seektable", "1000-samples-seektable",
        "64-frames-verify-seektable"])
def test_depth_two_writes_depth_ones_stream_and_flac_tpus(tmp_path, size, verify, seekpoints):
    pcm = _signal(N)
    got = _stream(pcm, size, 2, verify=verify, seekpoints=seekpoints)
    assert got == _stream(pcm, size, 1, seekpoints=seekpoints)
    assert got == _flac_tpu(tmp_path, pcm, seekpoints)


@pytest.mark.parametrize("n", [B * BS + TAIL, 0, 7 * BS],
                         ids=["one-batch", "empty", "whole-frames"])
def test_depth_two_at_the_edges_of_the_stream(tmp_path, n):
    pcm = _signal(n)
    batches = t_enc.pipeline_batches
    got = _stream(pcm, None, 2, seekpoints=SEEKPOINTS)
    # one batch; none; 4 and 2 frames in process() and the last one in finish()
    assert t_enc.pipeline_batches - batches == {B * BS + TAIL: 1, 0: 0, 7 * BS: 3}[n]
    assert got == _stream(pcm, None, 1, seekpoints=SEEKPOINTS)
    if n:
        assert got == _flac_tpu(tmp_path, pcm, SEEKPOINTS)


def _plant_mismatch(monkeypatch, frame: int) -> None:
    """verify compares the batch holding `frame` with an input altered there."""
    real = StreamEncoder._run_verify

    def altered(self, rows, nframes, pcm_batch, total_bits):
        f = frame - self._frame_no
        if 0 <= f < nframes:
            pcm_batch = pcm_batch.copy()
            pcm_batch[f, 5, 1] += 1
        real(self, rows, nframes, pcm_batch, total_bits)
    monkeypatch.setattr(StreamEncoder, "_run_verify", altered)


@pytest.mark.parametrize("depth", [1, 2])
def test_a_mismatch_in_the_carried_batch_raises_by_finish(monkeypatch, depth):
    _plant_mismatch(monkeypatch, 5)  # in the last batch of full frames, 4-6
    n = 7 * BS + TAIL
    sink = io.BytesIO()
    enc = _encoder(sink, n, depth, verify=True)
    if depth == 1:
        with pytest.raises(VerifyError, match="verify mismatch at frame 5 sample 5 channel 1"):
            enc.process(_signal(n))
        return
    enc.process(_signal(n))  # the batch of frames 4-6 is still in flight
    assert enc.stats.frames == 4
    with pytest.raises(VerifyError, match="verify mismatch at frame 5 sample 5 channel 1"):
        enc.finish()


@pytest.mark.parametrize("size,launched,behind", [
    (N, 3, 2),        # one call: three batches, each but the first behind another
    (BS, 11, 10),     # a one-frame batch a call, carried from call to call
    (11 * BS, 4, 3),  # 4, 4 and 2 frames, then the last one behind them in the next call
], ids=["one-call", "1-frame", "two-calls"])
def test_the_counters_count_batches_and_those_behind_another(size, launched, behind):
    pcm = _signal(N)
    for depth in (1, 2):
        batches, pipelined = t_enc.pipeline_batches, t_enc.pipelined_batches
        _stream(pcm, size, depth)
        assert t_enc.pipeline_batches - batches == launched
        assert t_enc.pipelined_batches - pipelined == (behind if depth == 2 else 0)


def test_process_returns_with_one_batch_in_flight_and_stats_count_what_was_written():
    pcm = _signal(N)
    sink = io.BytesIO()
    enc = _encoder(sink, N, 2)
    enc.process(pcm[: 3 * BS])  # frames 0-1 launched, frame 2 kept back
    assert (enc.stats.frames, enc.stats.samples, enc.stats.batches) == (0, 0, 0)
    header = sink.tell()
    enc.process(pcm[3 * BS :])  # frames 2-5, 6-9 and 10 launched, 0-9 written
    assert (enc.stats.frames, enc.stats.samples, enc.stats.batches) == (10, 10 * BS, 3)
    assert sink.tell() - header == enc.stats.bytes_written
    enc.finish()  # frame 10, then the tail
    assert (enc.stats.frames, enc.stats.samples, enc.stats.batches) == (12, N, 5)
    assert sink.getvalue() == _stream(pcm, None, 1)
