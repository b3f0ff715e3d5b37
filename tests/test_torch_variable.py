"""Variable-blocksize streams (blocking strategy 1) through the port's
decoder against flac_tpu's, on the CPU.

`index_frames_variable`'s four arrays, `decode_bytes_device`'s PCM, `path`
and `frames`, and `iter_blocks` must equal flac_tpu's on:
tests/test_device_decoder.py::TestVariableBlocksize's stream (mono 8-bit
verbatim frames of mixed blocksizes); its CRC-mismatch case; and a stereo
16-bit stream made from port-encoded frames re-headered as strategy 1 (two
groups on the device, three frames on the host). The frame decoder with
per-frame header widths (`dynamic_header_ext`) is held against flac_tpu's
on every output.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_signal
from flac_tpu.decode import frame_decoder as j_fd
from flac_tpu.decode import stream as j_stream
from flac_tpu.metadata import parse_metadata
from flac_tpu_torch import crc as t_crc
from flac_tpu_torch.decode import frame_decoder as t_fd
from flac_tpu_torch.decode import host_decoder as t_hd
from flac_tpu_torch.decode import stream as t_stream
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.md5 import MD5Context
from flac_tpu_torch.metadata import StreamInfo, serialize_block
from test_ogg import _make_variable_blocksize_flac

TEST_BSS = [64] * 10 + [160] * 8 + [96, 23] + [64] * 5


# --- a copy of chip_smoke.py's helper (chip_smoke imports nothing of tests/) --

def utf8_number(n: int) -> bytes:
    """FLAC's UTF-8 coding of a frame or sample number (up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    for nb in range(2, 8):
        if n < 1 << (5 * nb + 1):
            tail = [0x80 | ((n >> (6 * i)) & 0x3F) for i in range(nb - 2, -1, -1)]
            return bytes([((0xFF00 >> nb) & 0xFF) | (n >> (6 * (nb - 1)))] + tail)
    raise ValueError(f"{n} does not fit FLAC's UTF-8 coding")


def variable_blocksize_stream(pcm, segments, sample_rate, bps, encode):
    """A variable-blocksize FLAC stream of pcm[:sum(bs * n)]: each segment
    (blocksize, nframes) is encoded by `encode(pcm_segment, blocksize)` as a
    fixed-blocksize stream, and each of its frames re-headered as blocking
    strategy 1, with its first sample's number in UTF-8 and the CRC-8 and
    CRC-16 recomputed; the subframe bytes are unchanged. One STREAMINFO with
    the min/max blocksize and the input's MD5 goes in front."""
    frames, sizes, sample = [], [], 0
    for bs, nframes in segments:
        data = encode(pcm[sample:sample + bs * nframes], bs)
        _pcm, infos = t_hd.HostDecoder(data).decode_all()
        assert len(infos) == nframes and all(fi.blocksize == bs for fi in infos)
        for fi in infos:
            raw = data[fi.offset:fi.offset + fi.size]
            lead = raw[4]
            ulen = 1 + sum(lead >= b for b in (0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE))
            bs_code, sr_code = raw[2] >> 4, raw[2] & 15
            ext = ({6: 1, 7: 2}.get(bs_code, 0)
                   + {12: 1, 13: 2, 14: 2}.get(sr_code, 0))
            hdr = bytes([raw[0], raw[1] | 1, raw[2], raw[3]]) + utf8_number(sample) \
                + raw[4 + ulen:4 + ulen + ext]
            frame = hdr + bytes([t_crc.crc8(hdr)]) + raw[4 + ulen + ext + 1:-2]
            frame += t_crc.crc16(frame).to_bytes(2, "big")
            frames.append(frame)
            sizes.append(len(frame))
            sample += bs
    md5 = MD5Context()
    md5.accumulate(pcm[:sample], bps)
    si = StreamInfo(min_blocksize=min(bs for bs, _ in segments),
                    max_blocksize=max(bs for bs, _ in segments),
                    min_framesize=min(sizes), max_framesize=max(sizes),
                    sample_rate=sample_rate, channels=pcm.shape[1],
                    bits_per_sample=bps, total_samples=sample, md5sum=md5.digest())
    return b"fLaC" + serialize_block(si, is_last=True) + b"".join(frames)


# -----------------------------------------------------------------------------

SEGMENTS = [(576, 2), (256, 4), (1000, 1), (576, 2), (1000, 2)]


@pytest.fixture(scope="module")
def reheadered(tmp_path_factory):
    """(stream, pcm) of the re-headered stereo 16-bit stream, made once."""
    tmp_path = tmp_path_factory.mktemp("segments")
    sig = make_signal(sum(bs * n for bs, n in SEGMENTS), 2, 16, kind="sine", seed=21)

    def encode(seg, bs):
        path = tmp_path / f"seg{bs}.flac"
        t_enc.encode_file(seg, 44100, 16, str(path), level=5, blocksize=bs,
                          batch_frames=4, device="cpu")
        return path.read_bytes()

    return variable_blocksize_stream(sig, SEGMENTS, 44100, 16, encode), sig


def _index_both(data):
    d = np.frombuffer(data, np.uint8)
    blocks, ao = parse_metadata(data)
    return (j_stream.index_frames_variable(d, ao, blocks[0]),
            t_stream.index_frames_variable(d, ao, blocks[0]))


def _decode_both(data, batch_frames, iter_blocks=True):
    kw = dict(batch_frames=batch_frames, max_lpc_order=12)  # level 5's orders
    jp, _, jinfo = j_stream.decode_bytes_device(data, **kw)
    tp, _, tinfo = t_stream.decode_bytes_device(data, device="cpu", **kw)
    np.testing.assert_array_equal(tp, jp)
    for k in ("frames", "path", "errors"):
        assert tinfo[k] == jinfo[k], k
    if iter_blocks:
        blocks = list(t_stream.StreamDecoder(data, device="cpu", **kw).iter_blocks())
        assert len(blocks) == 1
        np.testing.assert_array_equal(blocks[0], tp)
    return tp, tinfo


@pytest.mark.parametrize("stream", ["test_device_decoder", "reheadered_stereo16"])
def test_index_frames_variable_matches(reheadered, stream):
    if stream == "test_device_decoder":
        data = _make_variable_blocksize_flac(TEST_BSS)[0]
    else:
        data = reheadered[0]
    ref, got = _index_both(data)
    assert ref is not None and got is not None
    assert len(got) == 4
    for r, g in zip(ref, got):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, r)
    if stream == "test_device_decoder":
        np.testing.assert_array_equal(got[1], TEST_BSS)
        assert set(got[3]) == {16}  # the 16-bit blocksize at the header's end
    else:
        np.testing.assert_array_equal(
            got[1], [bs for bs, n in SEGMENTS for _ in range(n)])


def test_grouped_device_decode_matches():
    data, _, pcm = _make_variable_blocksize_flac(TEST_BSS)
    out, info = _decode_both(data, batch_frames=8)
    np.testing.assert_array_equal(out.reshape(-1), pcm)
    assert info["path"] == "device-variable" and info["frames"] == len(TEST_BSS)
    assert info["host_frames"] == 2 and info["overflow_frames"] == 0  # 96 and 23


def test_reheadered_stereo_stream_matches(reheadered):
    """Groups of 576 (4 frames) and 256 (4 frames) on the device, three
    frames of 1000 on the host (_VAR_MIN_GROUP); MD5 checked. (iter_blocks
    is held against decode_all on the other stream.)"""
    data, sig = reheadered
    out, info = _decode_both(data, batch_frames=4, iter_blocks=False)
    np.testing.assert_array_equal(out, sig)
    assert info["path"] == "device-variable" and info["frames"] == 11
    assert info["host_frames"] == 3 and info["overflow_frames"] == 0


def test_crc_mismatch_raises_alike():
    data, _, _ = _make_variable_blocksize_flac([64] * 8 + [160] * 8)
    data = bytearray(data)
    data[-40] ^= 0x20  # inside the last frame's body
    errors = (j_stream.hd.DecodeError, j_stream.StreamDecodeError)
    with pytest.raises(errors) as jerr:
        j_stream.decode_bytes_device(bytes(data), batch_frames=8, max_lpc_order=12)
    with pytest.raises((t_hd.DecodeError, t_stream.StreamDecodeError)) as terr:
        t_stream.decode_bytes_device(bytes(data), batch_frames=8, max_lpc_order=12,
                                     device="cpu")
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


def test_frame_decoder_with_per_frame_header_widths_matches(reheadered):
    """The 1000-sample frames of the re-headered stream (their blocksize in
    16 bits at the header's end) decoded with dynamic_header_ext, every
    output against flac_tpu's; and read_frame_header with a [B] width
    tensor against the int width on every frame."""
    data = reheadered[0]
    _, (offsets, bss, _snos, exts) = _index_both(data)
    sel = np.flatnonzero(bss == 1000)
    d = np.frombuffer(data, np.uint8)
    words = t_fd.bytes_to_words(d, bucket=True)
    kw = dict(blocksize=1000, channels=2, bits_per_sample=16, sample_rate=44100,
              max_lpc_order=12, dynamic_header_ext=True)
    jdec = j_fd.build_frame_decoder(j_fd.DecoderGeometry(**kw))
    tdec = t_fd.build_frame_decoder(t_fd.DecoderGeometry(**kw), device="cpu")
    jp, je, jm = jdec(jnp.asarray(words), jnp.asarray(offsets[sel] * 8),
                      jnp.asarray(exts[sel]))
    tp, te, tm = tdec(words, offsets[sel] * 8, exts[sel])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for k in ("sync_ok", "assignment", "subframe_type", "order", "wasted",
              "unary_overflow"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    w, pos = torch.as_tensor(words), torch.as_tensor(offsets * 8)
    got = t_fd.read_frame_header(w, pos, torch.as_tensor(exts), 2)
    assert set(exts.tolist()) == {0, 16}  # 576/256 by code, 1000 at the end
    for e in (0, 16):
        m = torch.as_tensor(exts == e)
        ref = t_fd.read_frame_header(w, pos, e, 2)
        for g, r in zip(got, ref):
            assert torch.equal(g[m], r[m])
