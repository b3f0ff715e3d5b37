"""The plain reference decoder (cardbench/reference) against streams that
the port writes on the CPU, against hand-made frames of every kind, and
against corrupted bytes, which it must reject."""

from __future__ import annotations

import io

import numpy as np
import pytest

from cardbench import traffic
from cardbench.reference import crc, flac, md5
from cardbench.tests import flacwriter as fw

from flac_tpu_torch.encode.encoder import StreamEncoder
from flac_tpu_torch.encode.frame_encoder import EncoderConfig
from flac_tpu_torch.md5 import md5_of_pcm


def port_stream(pcm, level, bits, rate=44100, blocksize=1024, batch=8, **over):
    cfg = EncoderConfig.from_level(level, pcm.shape[1], bits, rate, blocksize=blocksize, **over)
    sink = io.BytesIO()
    enc = StreamEncoder(cfg, sink, batch_frames=batch, total_samples_estimate=len(pcm),
                        device="cpu")
    enc.process(pcm)
    enc.finish()
    return sink.getvalue()


def assignments(data: bytes) -> set:
    si, audio = flac.parse_metadata(data)
    return set(flac._headers(np.frombuffer(data, np.uint8), audio, si)["assignment"].tolist())


def stereo_cases(bits: int) -> np.ndarray:
    """Frames of 1024 samples: independent noise, equal channels, a loud
    left over a quiet right and the reverse, then a tone, digital silence
    and a loud noise burst; 600 samples more make a partial last frame."""
    r = np.random.default_rng(bits)
    full = (1 << (bits - 1)) - 1
    T = 1024
    t = np.arange(T)
    tone = np.round(0.6 * full * np.sin(2 * np.pi * t / 37.0))
    quiet = r.normal(0, full / 3000, T)
    parts = [np.stack([r.normal(0, full / 40, T), r.normal(0, full / 40, T)], -1),
             np.stack([tone + quiet, tone + quiet], -1),
             np.stack([tone + quiet, quiet], -1),
             np.stack([quiet, tone + quiet], -1),
             np.stack([tone + quiet, 0.9 * tone + quiet], -1),
             np.zeros((T, 2)),
             r.uniform(-full, full, (T, 2)),
             np.stack([tone[:600], -tone[:600]], -1)]
    return np.clip(np.round(np.concatenate(parts)), -full - 1, full).astype(np.int32)


@pytest.mark.parametrize("level,bits,over", [
    (5, 16, {}), (8, 24, {}), (5, 16, {"do_escape_coding": True}),
    (8, 16, {"do_escape_coding": True, "do_qlp_coeff_prec_search": True})])
def test_port_streams_decode_to_their_input(level, bits, over):
    pcm = stereo_cases(bits)
    data = port_stream(pcm, level, bits, **over)
    d, = flac.decode_streams([data], "cpu")
    assert d.errors == []
    assert np.array_equal(d.pcm, pcm)
    assert d.streaminfo.md5 == md5.flac_md5(pcm, bits) == md5_of_pcm(pcm, bits)
    assert d.streaminfo.total_samples == len(pcm)
    assert (d.streaminfo.min_framesize, d.streaminfo.max_framesize) == (
        d.frame_sizes.min(), d.frame_sizes.max())
    assert len(d.frame_sizes) == -(-len(pcm) // 1024)


def test_port_streams_hold_every_stereo_mode():
    seen = set()
    for level, bits in ((5, 16), (8, 24)):
        seen |= assignments(port_stream(stereo_cases(bits), level, bits))
    assert seen == {1, 8, 9, 10}  # independent, left/side, side/right, mid/side


def test_music_and_several_streams_in_one_call():
    """Streams of the benchmark's own signal, two widths decoded together."""
    a = traffic.music([9000, 7000], 44100, 16, 11, "album", "cpu").numpy()
    b = traffic.music([5000], 96000, 24, 12, "album", "cpu").numpy()
    streams = [port_stream(a, 5, 16), port_stream(b, 8, 24, rate=96000),
               port_stream(a[:3000], 5, 16)]
    got = flac.decode_streams(streams, "cpu")
    for d, want in zip(got, (a, b, a[:3000])):
        assert d.errors == [] and np.array_equal(d.pcm, want)


def _hand_stream():
    """Frames of every subframe kind the format has, hand-made."""
    r = np.random.default_rng(3)
    T, bps, rate = 192, 16, 44100
    t = np.arange(T)
    smooth = np.round(8000 * np.sin(2 * np.pi * t / 50.0)).astype(np.int64)
    noise = r.integers(-30000, 30000, T)
    frames, chans = [], []

    def add(assignment, a, b, sa, sb):
        n = len(frames)
        frames.append(fw.frame(n, T, rate, bps, assignment,
                               [lambda w: sa(w, a), lambda w: sb(w, b)]))
        if assignment == 8:
            a, b = a, a - b
        elif assignment == 9:
            a, b = a + b, b
        elif assignment == 10:
            mid = (a << 1) | (b & 1)
            a, b = (mid + b) >> 1, (mid - b) >> 1
        chans.append(np.stack([a, b], -1))

    def fixed(o, bits=bps, **kw):
        return lambda w, x: fw.subframe(w, x, bits, "fixed", order=o, params=[8] * (1 << kw.get("porder", 0)), **kw)

    # constant and verbatim; wasted bits
    add(1, np.full(T, -1234), noise, lambda w, x: fw.subframe(w, x, bps, "constant"),
        lambda w, x: fw.subframe(w, x, bps, "verbatim"))
    add(1, smooth * 8, noise & ~3, lambda w, x: fw.subframe(w, x, bps, "fixed", order=2,
                                                           wasted=3, params=[6]),
        lambda w, x: fw.subframe(w, x, bps, "verbatim", wasted=2))
    # fixed orders 0-4, partitioned, one partition escaped
    for o in range(5):
        add(1, smooth, smooth // 3, fixed(o, porder=2),
            lambda w, x, o=o: fw.subframe(w, x, bps, "fixed", order=o, porder=3,
                                          params=[None] + [9] * 7))
    # LPC order 12 and order 1, Rice2 parameters
    coefs = [3, -2, 1, 0, 1, -1, 2, 0, -1, 1, 0, 1]
    add(1, smooth, noise // 100,
        lambda w, x: fw.subframe(w, x, bps, "lpc", order=12, coefs=coefs, prec=5, shift=2,
                                 porder=1, params=[12, 12], method=1),
        lambda w, x: fw.subframe(w, x, bps, "lpc", order=1, coefs=[7], prec=4, shift=3,
                                 params=[9]))
    # the three stereo decorrelations (the side channel a bit wider)
    side = smooth // 7 - 5
    add(8, smooth, side, fixed(2), fixed(1, bits=bps + 1))
    add(9, side, smooth, fixed(1, bits=bps + 1), fixed(3))
    add(10, smooth, side, fixed(2), fixed(1, bits=bps + 1))
    pcm = np.concatenate(chans).astype(np.int32)
    return fw.stream(frames, pcm, rate, bps, T), pcm


def test_hand_made_frames_of_every_kind():
    data, pcm = _hand_stream()
    d, = flac.decode_streams([data], "cpu")
    assert d.errors == []
    assert np.array_equal(d.pcm, pcm)
    assert d.streaminfo.md5 == md5.flac_md5(pcm, 16)


@pytest.mark.parametrize("where", ["header", "crc8", "body", "crc16", "streaminfo_md5"])
def test_one_corrupted_byte_is_rejected(where):
    data, pcm = _hand_stream()
    si, audio = flac.parse_metadata(data)
    frames = flac._headers(np.frombuffer(data, np.uint8), audio, si)
    k = 4  # a frame in the middle
    start, end = int(frames["start"][k]), int(frames["start"][k + 1])
    at = {"header": start + 2, "crc8": start + int(frames["header"][k]) - 1,
          "body": (start + end) // 2, "crc16": end - 1, "streaminfo_md5": 8 + 18 + 5}[where]
    bad = bytearray(data)
    bad[at] ^= 0x24
    d, = flac.decode_streams([bytes(bad)], "cpu")
    if where == "streaminfo_md5":
        assert d.streaminfo.md5 != md5.flac_md5(pcm, 16)
    else:
        assert d.errors
        assert not np.array_equal(d.pcm, pcm) or any("CRC-16" in e for e in d.errors)


def test_crc_tables_match_the_bytewise_definitions():
    r = np.random.default_rng(0)
    data = r.integers(0, 256, 999, dtype=np.uint8).tobytes()

    def crc_bitwise(data, poly, width):
        c = 0
        for b in data:
            c ^= b << (width - 8)
            for _ in range(8):
                c = ((c << 1) ^ poly) if c & (1 << (width - 1)) else c << 1
                c &= (1 << width) - 1
        return c

    assert crc.crc8(data) == crc_bitwise(data, 0x07, 8)
    assert crc.crc16(data) == crc_bitwise(data, 0x8005, 16)
    assert crc.crc16(data[:-1]) == crc_bitwise(data[:-1], 0x8005, 16)
    import torch
    buf = torch.as_tensor(np.frombuffer(data + b"\0\0", np.uint8).astype(np.int64))
    starts, lengths = torch.tensor([0, 5, 17]), torch.tensor([999, 300, 1])
    got = crc.crc16_rows(buf, starts, lengths).tolist()
    assert got == [crc_bitwise(data[s:s + n], 0x8005, 16) for s, n in
                   zip(starts.tolist(), lengths.tolist())]


@pytest.mark.parametrize("n,bits", [(0, 16), (1, 16), (7, 24), (16, 16), (333, 24), (4097, 16)])
def test_md5_openssl_and_python_paths_agree_with_the_port(n, bits):
    pcm = np.random.default_rng(n).integers(-(1 << (bits - 1)), 1 << (bits - 1),
                                            (n, 2)).astype(np.int32)
    assert md5.flac_md5(pcm, bits) == md5.flac_md5(pcm, bits, use_openssl=False) \
        == md5_of_pcm(pcm, bits)
