"""The port's stream decoder against flac_tpu's, on the CPU.

`decode_bytes_device(device="cpu")` must give flac_tpu's PCM and the same
`frames`, `path` and `errors` on streams from both encoders (the port's own
count of host-decoded frames is checked on its own); cross round trips go
port encode -> flac_tpu decode and back; `iter_blocks` must equal
`decode_all`; the MD5 verdict comes at exhaustion; a corrupt frame raises in
strict mode and is concealed as flac_tpu conceals it. Streams use T=1024
frames, one batch each, with a final partial frame.
"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import make_signal
from flac_tpu.decode import stream as j_stream
from flac_tpu.encode import encoder as j_enc
from flac_tpu.metadata import parse_metadata
from flac_tpu_torch.decode import host_decoder as t_hd
from flac_tpu_torch.decode import stream as t_stream
from flac_tpu_torch.encode import encoder as t_enc

T = 1024
N = 4 * T + 300  # four full frames and a partial one
KW = dict(batch_frames=4, max_lpc_order=12)


def _encode(tmp_path, sig, which="torch", level=5):
    path = tmp_path / f"{which}.flac"
    if which == "torch":
        t_enc.encode_file(sig, 44100, 16, str(path), level=level, blocksize=T,
                          batch_frames=4, device="cpu")
    else:
        j_enc.encode_file(sig, 44100, 16, str(path), level=level, blocksize=T,
                          batch_frames=4)
    return path.read_bytes()


def _decode_both(data, **kw):
    jp, _jsi, jinfo = j_stream.decode_bytes_device(data, **KW, **kw)
    tp, tsi, tinfo = t_stream.decode_bytes_device(data, device="cpu", **KW, **kw)
    return jp, jinfo, tp, tinfo


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_decode_bytes_device_matches_flac_tpu(tmp_path, which):
    """Streams from both encoders (so also the cross round trips: the port's
    stream through flac_tpu's decoder, flac_tpu's through the port's)."""
    sig = make_signal(N, 2, 16, kind="sine", seed=1)
    data = _encode(tmp_path, sig, which)
    jp, jinfo, tp, tinfo = _decode_both(data)
    np.testing.assert_array_equal(jp, sig)
    np.testing.assert_array_equal(tp, sig)
    assert tp.dtype == np.int32
    for k in ("frames", "path", "errors"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["path"] == "device" and tinfo["frames"] == 5
    # the final partial frame is the host decoder's; no frame overflowed
    assert tinfo["host_frames"] == 1 and tinfo["overflow_frames"] == 0


def test_iter_blocks_equals_decode_all(tmp_path):
    sig = make_signal(N, 2, 16, kind="quiet", seed=4)
    data = _encode(tmp_path, sig)
    dec = t_stream.StreamDecoder(data, batch_frames=2, max_lpc_order=12, device="cpu")
    blocks = list(dec.iter_blocks())
    assert len(blocks) == 3, "two device batches and the partial frame"
    np.testing.assert_array_equal(np.concatenate(blocks), sig)
    pcm, info = t_stream.StreamDecoder(data, batch_frames=2, max_lpc_order=12,
                                       device="cpu").decode_all()
    np.testing.assert_array_equal(pcm, np.concatenate(blocks))
    assert info == dec.decode_info
    with pytest.raises(ValueError, match="strict"):
        next(t_stream.StreamDecoder(data, continue_on_error=True,
                                    device="cpu").iter_blocks())


def test_md5_verdict_raised_at_exhaustion(tmp_path):
    sig = make_signal(N, 2, 16, seed=5)
    data = bytearray(_encode(tmp_path, sig))
    data[26] ^= 0xFF  # a STREAMINFO md5 byte (offset 4 + 4 + 18)
    got = 0
    with pytest.raises(t_hd.DecodeError, match="MD5"):
        for block in t_stream.StreamDecoder(bytes(data), max_lpc_order=12,
                                            device="cpu").iter_blocks():
            got += len(block)
    assert got == len(sig), "all PCM is delivered before the MD5 verdict"


def _corrupt_body(data: bytes) -> bytes:
    """Flip one bit inside the third frame's subframe data."""
    d = np.frombuffer(data, np.uint8)
    blocks, ao = parse_metadata(data)
    offs = t_stream.index_frames(d, ao, blocks[0])
    out = bytearray(data)
    out[int(offs[2]) + 200] ^= 0x08
    return bytes(out)


def test_corrupt_crc16_raises_and_conceals_like_flac_tpu(tmp_path):
    sig = make_signal(N, 2, 16, kind="quiet", seed=6)
    data = _corrupt_body(_encode(tmp_path, sig))
    with pytest.raises(j_stream.hd.DecodeError):
        j_stream.decode_bytes_device(data, **KW)
    with pytest.raises(t_hd.DecodeError):
        t_stream.decode_bytes_device(data, device="cpu", **KW)
    jp, jinfo, tp, tinfo = _decode_both(data, continue_on_error=True)
    np.testing.assert_array_equal(tp, jp)
    for k in ("frames", "path", "errors"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["errors"], "the concealment is reported"


def test_index_and_crc16_match(tmp_path):
    sig = make_signal(N, 2, 16, kind="noise", seed=7)
    data = _encode(tmp_path, sig)
    d = np.frombuffer(data, np.uint8)
    blocks, ao = parse_metadata(data)
    offs = t_stream.index_frames(d, ao, blocks[0])
    np.testing.assert_array_equal(offs, j_stream.index_frames(d, ao, blocks[0]))
    ends = np.append(offs[1:], len(d))
    ends[1] -= 1  # a wrong length gives a CRC mismatch in frame 1
    np.testing.assert_array_equal(t_stream.check_frame_crc16(data, d, offs, ends),
                                  j_stream.check_frame_crc16(data, d, offs, ends))


def test_variable_blocksize_not_ported(tmp_path):
    from tests.test_ogg import _make_variable_blocksize_flac

    data, _, pcm = _make_variable_blocksize_flac([64] * 8 + [160] * 8)
    # ported: the grouped device decode gives flac_tpu's PCM, path and frames
    kw = dict(batch_frames=8, max_lpc_order=12)
    jp, _jsi, jinfo = j_stream.decode_bytes_device(data, **kw)
    tp, _tsi, tinfo = t_stream.decode_bytes_device(data, device="cpu", **kw)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp.reshape(-1), pcm)
    for k in ("frames", "path", "errors"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["path"] == "device-variable" and tinfo["host_frames"] == 0
    # concealing decodes of such streams are the host decoder's, as in flac_tpu
    out, _si, info = t_stream.decode_bytes_device(data, device="cpu",
                                                  continue_on_error=True)
    assert info["path"] == "host"
    np.testing.assert_array_equal(out.reshape(-1), pcm)
