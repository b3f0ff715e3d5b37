"""The length-generic tail step on the card (`-m cuda`): 20 streams with 20
distinct tail lengths, each taking the generic step, share one CUDA graph:
the step runs eagerly once, is captured once and replays 18 times, and
every stream is the CPU's bytes. Imports no JAX.

    python -m pytest tests/test_torch_tail_cuda.py -m cuda -q -n 0
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch import graphs
from flac_tpu_torch.encode import frame_encoder as t_fe
from flac_tpu_torch.encode.encoder import StreamEncoder


def _encode(cfg, pcm: np.ndarray, device: str) -> bytes:
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=4, total_samples_estimate=len(pcm),
                        device=device)
    enc.process(pcm)
    enc.finish()
    return sink.getvalue()


@pytest.mark.cuda
def test_twenty_tail_lengths_share_one_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    cfg = t_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=1024)
    rng = np.random.default_rng(18)
    tails = rng.choice(np.arange(41, cfg.blocksize), 20, replace=False)
    assert all(t_fe.tail_takes_generic_step(cfg, int(n)) for n in tails)
    streams = []
    for i, n in enumerate(tails):
        t = np.arange(2 * cfg.blocksize + int(n))[:, None]
        x = 8000 * np.sin(2 * np.pi * (220 + 37 * i) * (1 + np.arange(2)) * t / 44100)
        streams.append((x + rng.normal(0, 40, x.shape)).astype(np.int32))
    want = [_encode(cfg, pcm, "cpu") for pcm in streams]

    _encode(cfg, streams[0], "cuda")  # the full-frame step warmed and captured
    _encode(cfg, streams[0], "cuda")
    t_fe._graphed_tail.cache_clear()  # a fresh tail step: its first call is eager
    tail_calls = t_fe.tail_steps
    eager, captures, replays = graphs.eager_calls, graphs.captures, graphs.replays
    got = [_encode(cfg, pcm, "cuda") for pcm in streams]
    assert t_fe.tail_steps - tail_calls == 20
    assert graphs.eager_calls - eager == 1
    assert graphs.captures - captures == 1
    # 18 tail replays, and one replay of the full-frame batch a stream
    assert graphs.replays - replays == 18 + 20
    assert got == want
