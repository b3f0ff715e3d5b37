"""The port's 28- and 32-bit streams against flac_tpu, on the CPU.

`encode_file(verify=True)` at 28 bits (mid-side on, a 29-bit side channel,
the int64 LPC path) and 32 bits (mid-side off, 32-bit verbatim fields)
verifies every batch through the wide scan (the verifier's geometry takes
it above 26 bits) and writes flac_tpu's bytes; `decode_bytes_device` of
each must give flac_tpu's PCM, `frames`, `path` and `errors`, the final
partial frame decoded on the host. (tests/test_torch_verify_flagged.py
holds the frames the scans flag.)
"""

from __future__ import annotations

import numpy as np
import pytest

from flac_tpu.decode import stream as j_stream
from flac_tpu.encode import encoder as j_enc
from flac_tpu_torch.decode import stream as t_stream
from flac_tpu_torch.encode import encoder as t_enc
from test_torch_wide import _tonal

T = 1024


def _encode_both(tmp_path, sig, bps, verify):
    """The port's stream (verify on the port's side only) and flac_tpu's must
    be the same bytes; returns them."""
    kw = dict(level=5, blocksize=T, batch_frames=4)
    stats = t_enc.encode_file(sig, 44100, bps, str(tmp_path / "t.flac"), verify=verify,
                              device="cpu", **kw)
    assert stats.frames == 5 and stats.batches == 2
    j_enc.encode_file(sig, 44100, bps, str(tmp_path / "j.flac"), **kw)
    data = (tmp_path / "t.flac").read_bytes()
    assert data == (tmp_path / "j.flac").read_bytes()
    return data


def _device_decodes_match(data, sig):
    jp, _, jinfo = j_stream.decode_bytes_device(data, batch_frames=4, max_lpc_order=12)
    tp, _, tinfo = t_stream.decode_bytes_device(data, device="cpu", batch_frames=4,
                                                max_lpc_order=12)
    np.testing.assert_array_equal(jp, sig)
    np.testing.assert_array_equal(tp, sig)
    for k in ("frames", "path", "errors"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["path"] == "device"
    return tinfo


def _with_partial(frames: np.ndarray, bps: int) -> np.ndarray:
    """Four frames and a partial one of 300 samples."""
    tail = _tonal(bps, seed=bps + 2, noise_frame=False).reshape(-1, 2)[:300]
    return np.concatenate([frames.reshape(-1, 2), tail])


@pytest.mark.parametrize("bps", [28, 32])
def test_wide_stream_encode_and_device_decode_match(tmp_path, bps):
    sig = _with_partial(_tonal(bps, seed=bps + 1, noise_frame=False), bps)
    data = _encode_both(tmp_path, sig, bps, verify=True)
    info = _device_decodes_match(data, sig)
    assert info["host_frames"] == 1 and info["overflow_frames"] == 0  # the partial one
