"""The port's stream decoder against flac_tpu's on other geometries than
the main path's, on the CPU: flac_tpu's streams at level 0 (fixed
predictors only, T=1152), at level 8 (LPC up to order 12, 24-bit RICE2) and
mono. PCM, `frames`, `path` and `errors` must be equal; the port's count of
host-decoded frames is checked on its own."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import make_signal
from flac_tpu.decode import stream as j_stream
from flac_tpu.encode import encoder as j_enc
from flac_tpu_torch.decode import stream as t_stream


@pytest.mark.parametrize("level,channels,bps,blocksize,kind", [
    (0, 2, 16, 1152, "sine"),
    (8, 2, 24, 1024, "noise"),
    (5, 1, 16, 1024, "quiet"),
])
def test_flac_tpu_streams_decode_alike(tmp_path, level, channels, bps, blocksize, kind):
    sig = make_signal(3 * blocksize + 77, channels, bps, kind=kind, seed=17)
    path = tmp_path / "g.flac"
    j_enc.encode_file(sig, 44100, bps, str(path), level=level, blocksize=blocksize,
                      batch_frames=4)
    data = path.read_bytes()
    kw = dict(batch_frames=4, max_lpc_order=12)
    jp, _, jinfo = j_stream.decode_bytes_device(data, **kw)
    tp, _, tinfo = t_stream.decode_bytes_device(data, device="cpu", **kw)
    np.testing.assert_array_equal(jp, sig)
    np.testing.assert_array_equal(tp, sig)
    for k in ("frames", "path", "errors"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["host_frames"] == 1 + tinfo["overflow_frames"]
