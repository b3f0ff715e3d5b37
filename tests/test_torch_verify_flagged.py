"""Frames the residual scans flag, through both packages' verify, on the
CPU: both raise the same VerifyError on a valid stream (ROADMAP queue 3),
and without verify the stream decodes alike with the flagged frame on the
host decoder.
"""

from __future__ import annotations

import numpy as np
import pytest

from flac_tpu.encode import encoder as j_enc
from flac_tpu_torch.encode import encoder as t_enc
from test_torch_wide import _tonal
from test_torch_wide_stream import _device_decodes_match, _encode_both, _with_partial

T = 1024


@pytest.mark.parametrize("case", ["narrow_24bit_outliers", "wide_32bit_verbatim"])
def test_verify_on_frames_the_scan_flags_fails_alike(tmp_path, case):
    """Frames the scan flags are valid, and the stream decoder sends them to
    the host; but both verifiers compare the flagged frames' samples with
    the input all the same, so both packages raise the same VerifyError
    (ROADMAP queue 3). Two ways to be flagged: near-silent 24-bit frames
    with full-scale spikes, whose Rice outliers trip the narrow scan's
    guards; a 32-bit VERBATIM (noise) frame, whose 128 bits a step outrun
    the wide scan's 96-bit refill. Without verify, the 32-bit stream
    decodes on the device path with the flagged frame on the host."""
    if case == "narrow_24bit_outliers":
        bps, rng = 24, np.random.default_rng(3)
        amp = (1 << 23) - 1
        x = rng.integers(-3, 4, (4 * T, 2)).astype(np.int32)
        x[rng.integers(0, len(x), 40)] = rng.integers(-amp - 1, amp + 1, (40, 2)).astype(np.int32)
    else:
        bps, x = 32, _with_partial(_tonal(32, seed=33), 32)
    kw = dict(level=5, blocksize=T, batch_frames=4, verify=True)
    with pytest.raises(j_enc.VerifyError) as jerr:
        j_enc.encode_file(x, 44100, bps, str(tmp_path / "j.flac"), **kw)
    with pytest.raises(t_enc.VerifyError) as terr:
        t_enc.encode_file(x, 44100, bps, str(tmp_path / "t.flac"), device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    if bps == 32:
        info = _device_decodes_match(_encode_both(tmp_path, x, 32, verify=False), x)
        assert info["host_frames"] == 2 and info["overflow_frames"] == 1
