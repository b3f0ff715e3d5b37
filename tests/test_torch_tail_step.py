"""The length-generic step for a stream's final partial frame, on the CPU.

`frame_encoder.encode_tail` encodes the final partial frame of n samples
by one step for every length at which the step's static choices are those
of the full blocksize (`build_tail_encoder`: the frame zero-padded to the
blocksize, n as data), and by a step built for n below that. For tail
lengths x configurations (-5 16-bit stereo, -8 24-bit stereo, -0 mono,
-5 with two apodizations), the stream encoder's final frame must be the
bytes of a step built for n, the route counters must count the route that
the rule gives, and for a third of the cases the whole stream must be
flac_tpu's bytes. The step's autocorrelation is held bit for bit in
tests/test_torch_tail_autocorr.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import make_signal
from flac_tpu.encode import encoder as j_enc
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode import frame_encoder as t_fe

LENGTHS = (1, 3, 4, 9, 33, 40, 41, 42, 63, 64, 65, 100, 1023, 1024, 1025, 1057,
           2048, 4095)

# name: (level, channels, bits, sample rate, overrides, the shortest tail
# that takes the generic step: LPC lags of over 32 samples at -5's order 8,
# the 24-bit wide datapath from 64 samples, the fixed orders 0-4 from 5)
CONFIGS = {
    "l5_16bit_stereo": (5, 2, 16, 44100, {}, 41),
    "l8_24bit_stereo": (8, 2, 24, 96000, {}, 64),
    "l0_mono": (0, 1, 16, 44100, {}, 5),
    "l5_two_apodizations": (5, 2, 16, 44100,
                            {"apodizations": (("tukey", 0.5), ("hann", None))}, 41),
}
KINDS = ("sine", "quiet", "noise", "wasted", "constant")


def _cfg(name: str) -> t_fe.EncoderConfig:
    level, ch, bits, rate, over, _ = CONFIGS[name]
    return t_fe.EncoderConfig.from_level(level, ch, bits, rate, **over)


def _cases():
    cases = []
    for name in CONFIGS:
        bs = _cfg(name).blocksize
        cases += [(name, n) for n in LENGTHS if n < bs]
    # every third case also holds the whole stream against flac_tpu's
    return [pytest.param(name, n, i % 3 == 0, id=f"{name}-{n}")
            for i, (name, n) in enumerate(cases)]


@pytest.mark.parametrize("name,n,against_flac_tpu", _cases())
def test_tail_frame_matches_a_step_built_for_its_length(tmp_path, name, n,
                                                        against_flac_tpu):
    level, ch, bits, rate, over, generic_from = CONFIGS[name]
    cfg = _cfg(name)
    # a stream of the tail alone: flac_tpu then compiles one step a case
    sig = make_signal(n, ch, bits, seed=n, kind=KINDS[n % len(KINDS)])
    kw = dict(level=level, batch_frames=1, **over)
    before = (t_fe.tail_steps, t_fe.tail_builds)
    t_enc.encode_file(sig, rate, bits, str(tmp_path / "t.flac"), device="cpu", **kw)
    got = (tmp_path / "t.flac").read_bytes()
    route = (t_fe.tail_steps - before[0], t_fe.tail_builds - before[1])
    assert route == ((1, 0) if n >= generic_from else (0, 1))
    assert t_fe.tail_takes_generic_step(cfg, n) == (n >= generic_from)

    words, total_bits, _ = t_fe.build_frame_encoder(cfg, blocksize=n, device="cpu")(
        sig[None], np.asarray([0], np.int64))
    frame = words[0].numpy().astype(">u4").tobytes()[: int(total_bits[0]) // 8]
    assert got.endswith(frame)
    if against_flac_tpu:
        j_enc.encode_file(sig, rate, bits, str(tmp_path / "j.flac"), **kw)
        assert got == (tmp_path / "j.flac").read_bytes()


def test_generic_step_keeps_the_padding_out():
    """The same tail with other values in the padding gives the same frame:
    nothing from n on reaches a sum, a choice or a field."""
    cfg = _cfg("l5_16bit_stereo")
    n = 777
    tail = make_signal(n, 2, 16, seed=4, kind="quiet")
    step = t_fe.build_tail_encoder(cfg, device="cpu")
    pcm, fnos, lens, bank = t_fe.tail_inputs(cfg, tail, 3)
    want = step(pcm, fnos, lens, bank)
    noisy = pcm.copy()
    noisy[0, n:] = make_signal(cfg.blocksize - n, 2, 16, seed=5, kind="noise")
    banked = bank.copy()
    banked[:, n:] = 0.5
    got = step(noisy, fnos, lens, banked)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
