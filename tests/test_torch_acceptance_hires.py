"""The port's encode_file against flac_tpu's on the JAX package's acceptance
config 3 (tests/test_acceptance.py: 24-bit/96 kHz stereo at -8, two frames
of 4096 and a partial one), on the CPU: the same bytes, the port's own
verify passing (the narrow scan on 24-bit RICE2 frames, the restore at
order 12) and a lossless decode by the port's host decoder.
"""

from __future__ import annotations

import numpy as np

from conftest import make_signal
from flac_tpu.encode import encoder as j_enc
from flac_tpu_torch.decode import host_decoder as t_hd
from flac_tpu_torch.encode import encoder as t_enc


def test_acceptance_config3_encode_file_matches(tmp_path):
    sig = make_signal(4096 * 2 + 33, 2, 24, kind="quiet", seed=3)
    jp, tp = tmp_path / "j.flac", tmp_path / "t.flac"
    # batches of 2 frames: the stream does not depend on the batch size
    j_enc.encode_file(sig, 96000, 24, str(jp), level=8, batch_frames=2)
    stats = t_enc.encode_file(sig, 96000, 24, str(tp), level=8, batch_frames=2,
                              verify=True, device="cpu")
    data = tp.read_bytes()
    assert data == jp.read_bytes()
    assert stats.frames == 3 and stats.batches == 2
    pcm, si, _ = t_hd.decode_bytes(data)
    assert si.md5sum != b"\x00" * 16
    np.testing.assert_array_equal(pcm, sig)
