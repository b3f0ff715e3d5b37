"""`flac -8 -V` on 24-bit streams, on the CPU, in batches of 4 frames and
of 3: verify compares every frame with its input before it is written. A
batch's frames are decoded where they were packed; the frames the narrow
scan flags, and the final partial frame, are decoded on the host from their
own bytes. The input holds a near-silent frame, a full-scale burst that the
scan flags, full-scale outliers and a partial frame. In batches of 3 the
fourth frame is alone in a second batch, padded by repetition, so that the
frame numbers verify reports cross a batch boundary.

The plain reference decoder (cardbench/reference/flac.py, PyTorch alone)
decodes the stream to its input, and the samples verify compared, device
and host, equal the reference's, frame by frame.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from cardbench.reference import flac as ref
from flac_tpu_torch.decode import host_decoder as hd
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode import frame_encoder as t_fe

T = 1024
FRAMES = 5  # four full frames and the partial one
FLAGGED = 1  # the frame of the full-scale burst
TAIL = 300


def _pcm() -> np.ndarray:
    """Four frames of 24-bit stereo and a partial one: near silence, a tone
    whose last quarter is full-scale noise (flagged by the narrow scan at
    -8), near silence with full-scale outliers, the tone, and a near-silent
    tail with one full-scale sample."""
    rng = np.random.default_rng(5)
    amp = (1 << 23) - 1
    n = 4 * T + TAIL
    t = np.arange(n)[:, None]
    x = 2 ** 21 * np.sin(2 * np.pi * 441.0 * (1 + np.arange(2)) * t / 96000)
    x = x + rng.normal(0, 2 ** 15, (n, 2))
    x[:T] = rng.integers(-3, 4, (T, 2))
    x[T + 3 * T // 4:2 * T] = rng.integers(-amp - 1, amp + 1, (T // 4, 2))
    x[2 * T:3 * T] = rng.integers(-3, 4, (T, 2))
    x[rng.integers(2 * T, 3 * T, 6)] = rng.integers(-amp - 1, amp + 1, (6, 2))
    x[-TAIL:] = rng.integers(-3, 4, (TAIL, 2))
    x[-50] = amp
    return np.round(x).astype(np.int32)


PCM = _pcm()


def _encode(batch_frames: int, verify: bool) -> tuple[bytes, t_enc.EncodeStats]:
    """One stream at -8, `batch_frames` frames a batch."""
    cfg = t_fe.EncoderConfig.from_level(8, 2, 24, 96000, blocksize=T)
    out = io.BytesIO()
    enc = t_enc.StreamEncoder(cfg, out, batch_frames=batch_frames,
                              total_samples_estimate=len(PCM), verify=verify, device="cpu")
    enc.process(PCM)
    enc.finish()
    return out.getvalue(), enc.stats


@pytest.fixture(scope="module")
def unverified() -> bytes:
    """The verify=False stream (the same bytes in batches of 4 and of 3)."""
    return _encode(4, False)[0]


def _spy(monkeypatch, batch_frames, corrupt_device=None, corrupt_host=None) -> dict:
    """Record what verify compares: the verifier's (pcm, flagged) of each
    batch and each host decode's (frame number, pcm); optionally alter a
    sample of either, as a fault of that decode would. A batch's first
    frame is `batch_frames` times the batches seen before it."""
    seen = {"device": [], "host": []}
    make = t_enc.make_verifier

    def make_spy(cfg, device):
        verify = make(cfg, device)

        def spy(rows):
            pcm, flagged = verify(rows)
            if corrupt_device is not None:
                frame, sample, channel = corrupt_device
                f = frame - batch_frames * len(seen["device"])
                if 0 <= f < len(pcm):
                    pcm = pcm.clone()
                    pcm[f, sample, channel] += 1
            seen["device"].append((pcm.numpy().copy(), flagged.numpy().copy()))
            return pcm, flagged
        return spy

    decode_frame_at = hd.HostDecoder.decode_frame_at

    def host_spy(self, byte_offset):
        pcm, info = decode_frame_at(self, byte_offset)
        if corrupt_host is not None and info.frame_number == corrupt_host[0]:
            pcm = pcm.copy()
            pcm[corrupt_host[1:]] += 1
        seen["host"].append((info.frame_number, pcm.copy()))
        return pcm, info

    monkeypatch.setattr(t_enc, "make_verifier", make_spy)
    monkeypatch.setattr(hd.HostDecoder, "decode_frame_at", host_spy)
    return seen


@pytest.mark.parametrize("batch_frames", [4, 3])
def test_verify_passes_compares_every_frame_and_writes_the_same_bytes(
        monkeypatch, unverified, batch_frames):
    seen = _spy(monkeypatch, batch_frames)
    before = (t_enc.verified_frames, t_enc.verify_host_frames, t_enc.verify_ns)
    data, stats = _encode(batch_frames, True)
    assert data == unverified
    assert stats.frames == FRAMES
    # every frame compared; the flagged one and the tail on the host
    assert t_enc.verified_frames - before[0] == FRAMES
    assert t_enc.verify_host_frames - before[1] == FLAGGED + 1
    assert t_enc.verify_ns > before[2]
    # one verifier call a batch, on its frames alone (not the padding)
    assert [len(p) for p, _ in seen["device"]] == ([4] if batch_frames == 4 else [3, 1])
    dev_pcm = np.concatenate([p for p, _ in seen["device"]])
    flagged = np.concatenate([f for _, f in seen["device"]])
    assert np.flatnonzero(flagged).tolist() == [FLAGGED]
    assert [f for f, _ in seen["host"]] == [FLAGGED, FRAMES - 1]

    decoded, = ref.decode_streams([data], "cpu")
    assert decoded.errors == []
    np.testing.assert_array_equal(decoded.pcm, PCM)
    frames = [decoded.pcm[i * T:(i + 1) * T] for i in range(FRAMES)]
    for i in range(4):
        if not flagged[i]:
            np.testing.assert_array_equal(dev_pcm[i], frames[i])
    for f, pcm in seen["host"]:
        np.testing.assert_array_equal(pcm, frames[f])


@pytest.mark.parametrize("batch_frames", [4, 3])
@pytest.mark.parametrize("where,frame,sample,channel", [
    ("flagged_host", FLAGGED, 700, 1),
    ("device", 3, 7, 0),
    ("tail", FRAMES - 1, 250, 1),
])
def test_a_corrupted_sample_raises_naming_its_frame(monkeypatch, batch_frames, where,
                                                    frame, sample, channel):
    if where == "device":
        _spy(monkeypatch, batch_frames, corrupt_device=(frame, sample, channel))
    else:
        _spy(monkeypatch, batch_frames, corrupt_host=(frame, sample, channel))
    want = int(PCM[frame * T + sample, channel])
    with pytest.raises(t_enc.VerifyError,
                       match=rf"verify mismatch at frame {frame} sample {sample} "
                             rf"channel {channel}: expected {want}, got {want + 1}$"):
        _encode(batch_frames, True)
