"""The port's frame encoder against flac_tpu's on configurations that the
other tests do not reach, on the CPU.

`build_frame_encoder` (eager on the CPU) must give flac_tpu's words, bit
counts and per-subframe choices (flac_tpu's plain fill, `packer_impl="xla"`,
JAX on the CPU) on a batch of four frames that take every subframe type: a
sine with noise (LPC), a constant frame, full-scale noise (verbatim) and a
random walk (fixed). Each configuration drives the model selection over
another set of candidates, which is where the encoder's build-time tables
(the models' types and fixed orders, the stereo sources, the frame-number
thresholds) are read: several apodization windows, six channels at 48 kHz,
8 bits at level 8, three channels at 12 bits, each `disable_*_subframes`
flag, and escape coding at level 6.
"""

from __future__ import annotations

import numpy as np
import pytest

from flac_tpu.dsp import windows as j_windows
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu_torch.dsp import windows as t_windows
from flac_tpu_torch.encode import frame_encoder as t_fe

APODIZATIONS = "tukey(0.5);hann;gauss(0.2)"

# name -> (level, channels, bits, rate, blocksize, overrides)
CONFIGS = {
    "three_apodizations": (5, 2, 16, 44100, 256, {"apodizations": APODIZATIONS}),
    "six_channels_48k": (5, 6, 16, 48000, 256, {}),
    "8bit_level8": (8, 2, 8, 44100, 256, {}),
    "three_channels_12bit": (5, 3, 12, 44100, 256, {}),
    "no_constant_subframes": (5, 2, 16, 44100, 256, {"disable_constant_subframes": True}),
    "no_fixed_subframes": (5, 2, 16, 44100, 256, {"disable_fixed_subframes": True}),
    "no_verbatim_subframes": (5, 2, 16, 44100, 256, {"disable_verbatim_subframes": True}),
    "escapes_level6": (6, 2, 16, 44100, 256, {"do_escape_coding": True}),
}


def _batch(channels: int, bits: int, T: int, seed: int) -> np.ndarray:
    """[4, T, channels] int32: sine + noise, constant, full-scale noise, a
    random walk; a full-scale burst in the first frame's last quarter."""
    rng = np.random.default_rng(seed)
    amp = (1 << (bits - 1)) - 1
    t = np.arange(T, dtype=np.float64)[:, None]
    ch = np.arange(channels)[None, :]
    sine = 0.5 * amp * np.sin(2 * np.pi * (300.0 + 170.0 * ch) * t / 44100)
    sine = sine + rng.normal(0, amp / 200 + 1, (T, channels))
    sine[3 * T // 4:] = rng.integers(-amp - 1, amp + 1, (T - 3 * T // 4, channels))
    constant = np.broadcast_to(np.round(amp / 3.0) - 5 * ch, (T, channels))
    noise = rng.integers(-amp - 1, amp + 1, (T, channels))
    walk = np.cumsum(rng.normal(0, max(amp / 500, 1.0), (T, channels)), axis=0)
    frames = np.stack([sine, constant, noise, walk])
    return np.clip(np.round(frames), -amp - 1, amp).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_frame_encoder_matches_flac_tpu(name):
    level, channels, bits, rate, T, overrides = CONFIGS[name]
    j_over, t_over = dict(overrides), dict(overrides)
    if "apodizations" in overrides:
        j_over["apodizations"] = j_windows.parse_apodization_spec(overrides["apodizations"])
        t_over["apodizations"] = t_windows.parse_apodization_spec(overrides["apodizations"])
    jc = j_fe.EncoderConfig.from_level(level, channels, bits, rate, blocksize=T, **j_over)
    tc = t_fe.EncoderConfig.from_level(level, channels, bits, rate, blocksize=T, **t_over)
    pcm = _batch(channels, bits, T, seed=level * 100 + channels * 10 + bits)
    fnos = np.arange(70, 74, dtype=np.int64)
    jw, jt, jinfo = j_fe.build_frame_encoder(jc, packer_impl="xla")(pcm, fnos)
    tw, tt, tinfo = t_fe.build_frame_encoder(tc, device="cpu")(pcm, fnos)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  np.asarray(jw).view(np.uint32))
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    types = set(np.asarray(jinfo["subframe_type"]).ravel().tolist())
    assert len(types) >= 2, types  # the batch reached more than one subframe type
