"""Seek and bounded streaming through the port against flac_tpu, on the CPU.

One stereo 16-bit stream (the port's encoder, with a seektable) of 10 full
frames of 512 and a partial frame (at
least the 8 frames from which a read goes to the device batches,
SeekableDecoder._DEVICE_MIN_FRAMES): `decode_range` at several positions
(reads on the device path from a frame start and from mid-frame, a read
inside one frame on the host, the final partial frame) and
`ChunkedStreamDecoder`'s concatenated blocks with a window small enough to
need several windows must give flac_tpu's PCM and the input. Ogg input
raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from conftest import make_signal
from flac_tpu.decode import seek as j_seek
from flac_tpu.decode import streaming as j_streaming
from flac_tpu_torch.decode import seek as t_seek
from flac_tpu_torch.decode import streaming as t_streaming
from flac_tpu_torch.encode import encoder as t_enc

T = 512
N = 10 * T + 300


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    sig = make_signal(N, 2, 16, kind="sine", seed=5)
    path = tmp_path_factory.mktemp("seek") / "s.flac"
    t_enc.encode_file(sig, 44100, 16, str(path), level=5, blocksize=T, batch_frames=4,
                      seekpoints=[0, 4 * T], device="cpu")
    return path.read_bytes(), sig


@pytest.mark.parametrize("start,n", [
    (0, 9 * T),             # 9 frames from the first: the device path
    (700, 9 * T + 100),     # from mid-frame, across the seekpoint
    (3 * T + 7, 200),       # inside one frame: the host decoder
    (N - 250, 250),         # the final partial frame
])
def test_decode_range_matches(stream, start, n):
    data, sig = stream
    ref = j_seek.SeekableDecoder(data).decode_range(start, n)
    dec = t_seek.SeekableDecoder(data, device="cpu")
    got = dec.decode_range(start, n)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, sig[start:start + n])
    assert got.dtype == np.int32


def test_seek_errors_match(stream):
    data, _ = stream
    for target in (-1, N):
        with pytest.raises(j_seek.SeekError) as jerr:
            j_seek.SeekableDecoder(data).seek_absolute(target)
        with pytest.raises(t_seek.SeekError) as terr:
            t_seek.SeekableDecoder(data, device="cpu").seek_absolute(target)
        assert str(terr.value) == str(jerr.value)


def test_chunked_decoder_matches(stream):
    """window_bytes=1 is raised to 8 of the stream's largest frames, which
    still takes more than one window over this stream."""
    data, sig = stream
    ref = j_streaming.ChunkedStreamDecoder(io.BytesIO(data), window_bytes=1,
                                           batch_frames=4)
    ref_blocks = list(ref.iter_blocks())
    dec = t_streaming.ChunkedStreamDecoder(io.BytesIO(data), window_bytes=1,
                                           batch_frames=4, device="cpu")
    blocks = list(dec.iter_blocks())
    assert len(data) > dec.window and len(blocks) > 1
    assert [len(b) for b in blocks] == [len(b) for b in ref_blocks]
    np.testing.assert_array_equal(np.concatenate(blocks), np.concatenate(ref_blocks))
    np.testing.assert_array_equal(np.concatenate(blocks), sig)
    assert dec.decode_info == ref.decode_info
    assert dec.decode_info["path"] == "chunked-device"


def test_ogg_input_raises_not_ported(stream):
    with pytest.raises(NotImplementedError, match="item 11"):
        t_seek.SeekableDecoder(b"OggS" + stream[0], device="cpu")
