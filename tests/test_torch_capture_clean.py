"""The encode step has nothing in it that a CUDA graph cannot record.

On CUDA `build_frame_encoder` captures its step (the fields stage and
`pack`) into a CUDA graph (flac_tpu_torch/graphs.py). A capture fails, or
records stale data, wherever a call makes a tensor from host data (an
upload: `torch.tensor`, `torch.as_tensor` of a list, an array or a number)
or reads a device value on the host (`.item()`, `bool()`, `int()`,
`.tolist()`, a boolean-mask index). On the CPU both show as aten ops:
`aten.lift_fresh` and `aten.lift_fresh_copy` for an upload,
`aten._local_scalar_dense` for a read, `aten.nonzero` for a mask index.
One call of the step, its inputs already tensors, runs under a
`TorchDispatchMode` that records them, at four configurations whose paths
differ: level 5 16-bit stereo, level 8 24-bit (the two-limb wide residual),
`-p` with escape coding, and 32-bit with mid-side off (the int64 path);
and so does the length-generic tail step (`build_tail_encoder`) at each.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flac_tpu_torch.encode import frame_encoder as t_fe

FORBIDDEN = ("aten.lift_fresh", "aten.lift_fresh_copy", "aten._local_scalar_dense",
             "aten.nonzero")
B = 4

CONFIGS = {
    "level5_16bit_stereo": dict(level=5, bits=16, rate=44100, blocksize=1152),
    "level8_24bit": dict(level=8, bits=24, rate=96000, blocksize=1152),
    "p_search_escapes": dict(level=5, bits=16, rate=44100, blocksize=1152,
                             do_qlp_coeff_prec_search=True, do_escape_coding=True),
    "32bit_independent": dict(level=5, bits=32, rate=44100, blocksize=256,
                              do_mid_side=False),
}


class _Recorder(TorchDispatchMode):
    """Records every forbidden op dispatched, with its count."""

    def __init__(self):
        super().__init__()
        self.seen: dict[str, int] = {}
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = str(func.overloadpacket)
        if name in FORBIDDEN:
            self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _pcm(cfg, seed: int) -> torch.Tensor:
    """B frames: a sine with noise on every channel, a full-scale burst in
    the last frame (escaped partitions where escape coding is on)."""
    rng = np.random.default_rng(seed)
    T, Ch, bits = cfg.blocksize, cfg.channels, cfg.bits_per_sample
    t = np.arange(B * T, dtype=np.float64)[:, None]
    amp = float(2 ** (bits - 2))
    x = amp * np.sin(2 * np.pi * 441.0 * (1 + np.arange(Ch)) * t / cfg.sample_rate)
    x = x + rng.normal(0, amp / 64, (B * T, Ch))
    x[-T // 4:] = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1), (T // 4, Ch))
    return torch.as_tensor(np.round(x).astype(np.int64).astype(np.int32).reshape(B, T, Ch))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_step_uploads_and_reads_nothing(name):
    kw = dict(CONFIGS[name])
    level, bits, rate, bs = kw.pop("level"), kw.pop("bits"), kw.pop("rate"), kw.pop("blocksize")
    cfg = t_fe.EncoderConfig.from_level(level, 2, bits, rate, blocksize=bs, **kw)
    step = t_fe.build_frame_encoder(cfg, device="cpu")
    pcm = _pcm(cfg, seed=level + bits)
    fnos = torch.arange(1000, 1000 + B, dtype=torch.int64)
    want = step(pcm, fnos)  # outside the recorder: what the step computes
    with _Recorder() as rec:
        words, total_bits, info = step(pcm, fnos)
    assert rec.seen == {}, f"{name}: {rec.seen} in {rec.ops} ops"
    assert rec.ops > 1000  # the recorder saw the step
    assert torch.equal(words, want[0]) and torch.equal(total_bits, want[1])
    assert int(total_bits.min()) > 0 and int((total_bits % 8).max()) == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tail_step_uploads_and_reads_nothing(name):
    kw = dict(CONFIGS[name])
    level, bits, rate, bs = kw.pop("level"), kw.pop("bits"), kw.pop("rate"), kw.pop("blocksize")
    cfg = t_fe.EncoderConfig.from_level(level, 2, bits, rate, blocksize=bs, **kw)
    n = bs - 57
    assert t_fe.tail_takes_generic_step(cfg, n)
    step = t_fe.build_tail_encoder(cfg, device="cpu")
    args = [torch.as_tensor(a) for a in
            t_fe.tail_inputs(cfg, _pcm(cfg, seed=level + bits).numpy()[-1, :n], 1003)]
    want = step(*args)
    with _Recorder() as rec:
        words, total_bits, info = step(*args)
    assert rec.seen == {}, f"{name}: {rec.seen} in {rec.ops} ops"
    assert rec.ops > 1000
    assert torch.equal(words, want[0]) and torch.equal(total_bits, want[1])
    assert int(total_bits[0]) > 0 and int(total_bits[0]) % 8 == 0
