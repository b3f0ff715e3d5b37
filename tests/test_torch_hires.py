"""The port's exhaustive search and -p sweep against flac_tpu, on the CPU.

`build_frame_encoder` (B=4, T=1024) must give flac_tpu's words, bit counts
and every info array at level 8 on 24-bit/96 kHz stereo (the exhaustive
search over 12 LPC orders and every fixed order, the two-limb wide
residual), at level 7 on 16-bit stereo, and with the -p precision sweep at
level 5 (16 bits) and level 8 (24 bits). The float stages before the
quantizer (autocorrelation to lag 12 of 24-bit frames, Levinson) are not
held to a tolerance here: the outputs must be identical, which is the
stronger check of them. (tests/test_torch_acceptance_hires.py holds
encode_file on the JAX package's 24-bit -8 acceptance config.)
"""

from __future__ import annotations

import numpy as np
import pytest

from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu_torch.encode import frame_encoder as t_fe
from test_torch_wide import _tonal

T = 1024


@pytest.mark.parametrize("level,bps,rate,overrides", [
    (8, 24, 96000, {}),
    (7, 16, 44100, {}),
    (5, 16, 44100, {"do_qlp_coeff_prec_search": True}),
    (8, 24, 96000, {"do_qlp_coeff_prec_search": True}),
], ids=["level8_24bit", "level7_16bit", "p_level5_16bit", "p_level8_24bit"])
def test_frame_encoder_matches(level, bps, rate, overrides):
    jc = j_fe.EncoderConfig.from_level(level, 2, bps, rate, blocksize=T, **overrides)
    tc = t_fe.EncoderConfig.from_level(level, 2, bps, rate, blocksize=T, **overrides)
    pcm = _tonal(bps, seed=level + bps)
    fnos = np.arange(4, dtype=np.int64)
    jw, jt, jinfo = j_fe.build_frame_encoder(jc, packer_impl="xla")(pcm, fnos)
    tw, tt, tinfo = t_fe.build_frame_encoder(tc, device="cpu")(pcm, fnos)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    assert (tinfo["subframe_type"] == 3).any()  # LPC candidates won somewhere
