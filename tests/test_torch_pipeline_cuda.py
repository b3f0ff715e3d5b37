"""The two-deep encode pipeline on the card (`-m cuda`; each test skips
without a GPU). Replays of one GraphedStep launched back to back, with no
sync between them and the caller's input rewritten after each call, equal
eager calls: no staging buffer is overwritten before the device has read
it. A stream encoded on CUDA (depth 2) is the CPU's bytes at -5 16-bit and
at -8 24-bit with verify. Imports no JAX.

    python -m pytest tests/test_torch_pipeline_cuda.py -m cuda -q -n 0
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch import graphs
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode.encoder import StreamEncoder
from flac_tpu_torch.encode.frame_encoder import EncoderConfig


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and page-locked staging run only there")


def _lcg(x, k):
    """A few milliseconds of exact integer work on the device a call (the
    first, eager, call gets the caller's host inputs)."""
    y, k = x.to("cuda", torch.int64), k.to("cuda")
    for _ in range(64):
        y = (y * 1103515245 + k) & 0x7FFFFFFF
    return y, y.sum()


@pytest.mark.cuda
def test_replays_in_flight_equal_eager_calls():
    _need_gpu()
    rng = np.random.default_rng(22)
    calls = [(rng.integers(0, 1 << 30, 1 << 22, dtype=np.int32),
              np.asarray([i + 1], np.int64)) for i in range(6)]
    want = [_lcg(torch.as_tensor(x, device="cuda"), torch.as_tensor(k, device="cuda"))
            for x, k in calls]
    step = graphs.GraphedStep(_lcg, "lcg", "cuda")
    replays = graphs.replays
    got = []
    for x, k in calls:  # eager, capture, then four replays with no sync between
        got.append(step(x, k))
        x[:] = -1  # the caller reuses its buffers as soon as the call returns
        k[:] = 0
    assert graphs.replays - replays == 4
    torch.cuda.synchronize()
    for (y, s), (wy, ws) in zip(got, want):
        assert torch.equal(y, wy) and torch.equal(s, ws)
    step.release()


def _signal(n: int, bps: int) -> np.ndarray:
    rng = np.random.default_rng(bps)
    t = np.arange(n)[:, None]
    amp = (1 << (bps - 1)) - 1
    x = 0.5 * amp * np.sin(2 * np.pi * (331 + 97 * np.arange(2)) * t / 44100)
    return np.clip(x + rng.normal(0, amp / 200, x.shape), -amp - 1, amp).astype(np.int32)


def _stream(cfg, pcm, sizes, device, verify=False) -> tuple[bytes, StreamEncoder]:
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=4, total_samples_estimate=len(pcm),
                        verify=verify, device=device)
    s = 0
    for k in sizes + [len(pcm)]:
        enc.process(pcm[s : s + k])
        s += k
    enc.finish()
    return sink.getvalue(), enc


@pytest.mark.cuda
@pytest.mark.parametrize("level,bps,rate,verify", [(5, 16, 44100, False),
                                                   (8, 24, 96000, True)],
                         ids=["-5-16-bit", "-8-24-bit-verify"])
def test_a_stream_on_the_card_is_the_cpus(level, bps, rate, verify):
    _need_gpu()
    cfg = EncoderConfig.from_level(level, 2, bps, rate)
    pcm = _signal(5 * 4 * cfg.blocksize + 777, bps)
    # one frame, then pieces that leave a batch in flight from call to call
    sizes = [cfg.blocksize + 1, 1, 6 * cfg.blocksize, 5000]
    batches, pipelined = t_enc.pipeline_batches, t_enc.pipelined_batches
    got, enc = _stream(cfg, pcm, sizes, "cuda", verify)
    assert enc.pipeline_depth == 2
    launched = t_enc.pipeline_batches - batches
    assert launched >= 5 and t_enc.pipelined_batches - pipelined == launched - 1
    assert got == _stream(cfg, pcm, sizes, "cpu")[0]
