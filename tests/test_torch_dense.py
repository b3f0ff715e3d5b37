"""The port's dense stream path against flac_tpu's, on the CPU.

The plain compaction (`compact_stream_words`, `compact_stream_bytes`) is
held against flac_tpu's jitted one bit for bit, on the four generated cases
of tests/test_dense_path.py::TestCompaction (seed 123) and on a real level-5
batch. `StreamEncoder` forced onto the dense route (FLAC_TPU_PACKER=pallas,
as flac_tpu's is forced in tests/test_dense_path.py) must write the port's
non-dense bytes and flac_tpu's dense bytes, seektable included, and its
verify must pass or raise as flac_tpu's dense verify does, with the same
message. The CUDA kernel is held against the plain version on the card
(`-m cuda`, and chip_smoke.py)."""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_signal
from flac_tpu.encode import encoder as j_enc
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu.encode import packer as j_packer
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode import frame_encoder as t_fe
from flac_tpu_torch.encode import packer as t_packer
from flac_tpu_torch.kernels import compact_stream

T = 1024


def _compaction_cases():
    """TestCompaction's four cases, regenerated from its seed: (words [B, W]
    int32, total_bits [B] int32, the expected byte stream)."""
    rng = np.random.default_rng(123)
    B, W = 37, 24
    cases = []
    for trial in range(4):
        nbytes = rng.integers(11, 4 * W + 1, B)
        if trial == 2:
            nbytes[::5] = 11          # lots of tiny frames
        if trial == 3:
            nbytes[:] = 4 * W         # full frames, phase 0 everywhere
        words = np.zeros((B, W), np.uint32)
        payloads = []
        for i, n in enumerate(nbytes):
            raw = rng.integers(0, 256, n, dtype=np.uint8)
            payloads.append(raw.tobytes())
            padded = np.zeros(4 * W, np.uint8)
            padded[:n] = raw
            words[i] = padded.view(">u4").astype(np.uint32)
        cases.append((words.view(np.int32), (nbytes * 8).astype(np.int32),
                      b"".join(payloads)))
    return cases


CASES = _compaction_cases()


def _real_batch():
    """The packed words of a level-5 stereo batch of 4 frames (the port's
    frame encoder on the CPU)."""
    cfg = t_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    sig = make_signal(4 * T, 2, 16, kind="sine", seed=11)
    words, total_bits, _ = t_fe.build_frame_encoder(cfg, device="cpu")(
        sig.reshape(4, T, 2), np.arange(4))
    return words.numpy(), total_bits.numpy()


def _check_compaction(words, total_bits):
    ref_w, ref_total = j_packer.compact_stream_words(jnp.asarray(words),
                                                     jnp.asarray(total_bits))
    got_w, got_total = t_packer.compact_stream_words(torch.as_tensor(words),
                                                     torch.as_tensor(total_bits))
    assert got_w.dtype == torch.int32 and got_total.dtype == torch.int64
    assert int(got_total) == int(ref_total)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(ref_w).view(np.uint32))
    ref_b, _ = j_packer.compact_stream_bytes(jnp.asarray(words), jnp.asarray(total_bits))
    got_b, _ = t_packer.compact_stream_bytes(torch.as_tensor(words),
                                             torch.as_tensor(total_bits))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))
    return got_w, int(got_total)


@pytest.mark.parametrize("trial", range(4))
def test_plain_compaction_matches_flac_tpu(trial):
    words, total_bits, expect = CASES[trial]
    got_w, total = _check_compaction(words, total_bits)
    assert total == len(expect)
    assert t_packer.stream_words_to_bytes(got_w.numpy(), total).tobytes() == expect


def test_plain_compaction_on_a_real_batch():
    words, total_bits = _real_batch()
    got_w, total = _check_compaction(words, total_bits)
    frames = b"".join(words[i].astype(">u4").tobytes()[: int(total_bits[i]) // 8]
                      for i in range(len(words)))
    assert t_packer.stream_words_to_bytes(got_w.numpy(), total).tobytes() == frames


def test_cpu_tensors_take_the_plain_compaction():
    words, total_bits, _ = CASES[0]
    w, tb = torch.as_tensor(words), torch.as_tensor(total_bits)
    before = compact_stream.launches
    got = t_packer.compact_stream_words_kernel(w, tb)
    ref = t_packer.compact_stream_words(w, tb)
    assert compact_stream.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_dense_route_rule(monkeypatch):
    """flac_tpu's _use_pallas_packer rule: pallas forces the dense route,
    xla never takes it, otherwise the device decides."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("FLAC_TPU_PACKER", raising=False)
    assert not t_fe.use_dense_packer(cpu) and t_fe.use_dense_packer(cuda)
    monkeypatch.setenv("FLAC_TPU_PACKER", "merged")
    assert not t_fe.use_dense_packer(cpu) and t_fe.use_dense_packer(cuda)
    monkeypatch.setenv("FLAC_TPU_PACKER", "pallas")
    assert t_fe.use_dense_packer(cpu)
    monkeypatch.setenv("FLAC_TPU_PACKER", "xla")
    assert not t_fe.use_dense_packer(cpu) and not t_fe.use_dense_packer(cuda)


def _encode_jax(sig, dense, bps=16, **kw):
    """flac_tpu's StreamEncoder, forced dense as tests/test_dense_path.py
    forces it."""
    cfg = j_fe.EncoderConfig.from_level(5, channels=2, bits_per_sample=bps,
                                        sample_rate=44100, blocksize=T)
    out = io.BytesIO()
    enc = j_enc.StreamEncoder(cfg, out, batch_frames=4, total_samples_estimate=len(sig),
                              **kw)
    if dense:
        enc._dense = True
        enc._encode = j_fe.build_frame_encoder_dense(cfg)
    enc.process(sig)
    enc.finish()
    return out.getvalue()


def _encode_torch(sig, monkeypatch, dense, bps=16, **kw):
    """The port's StreamEncoder on the CPU; FLAC_TPU_PACKER=pallas takes the
    dense route (set only around the port's build: flac_tpu reads it too)."""
    if dense:
        monkeypatch.setenv("FLAC_TPU_PACKER", "pallas")
    else:
        monkeypatch.delenv("FLAC_TPU_PACKER", raising=False)
    cfg = t_fe.EncoderConfig.from_level(5, channels=2, bits_per_sample=bps,
                                        sample_rate=44100, blocksize=T)
    out = io.BytesIO()
    enc = t_enc.StreamEncoder(cfg, out, batch_frames=4, total_samples_estimate=len(sig),
                              device="cpu", **kw)
    monkeypatch.delenv("FLAC_TPU_PACKER", raising=False)
    assert enc._dense == dense
    enc.process(sig)
    enc.finish()
    return out.getvalue(), enc.stats


def test_dense_stream_encoder_bytes_match(monkeypatch):
    """Batches of 4 and 2 frames and a partial frame: the dense route's bytes
    equal the non-dense route's and flac_tpu's dense ones, seektable
    filled."""
    monkeypatch.delenv("FLAC_TPU_PACKER", raising=False)
    sig = make_signal(T * 6 + 321, 2, 16, kind="quiet", seed=77)
    points = [0, 2048, 5000]
    ref = _encode_jax(sig, True, seekpoints=points)
    before = compact_stream.launches
    dense, stats = _encode_torch(sig, monkeypatch, True, seekpoints=points)
    plain, _ = _encode_torch(sig, monkeypatch, False, seekpoints=points)
    assert dense == ref
    assert plain == dense
    assert stats.batches == 3 and stats.frames == 7
    assert compact_stream.launches == before  # the CPU takes the plain compaction


@pytest.mark.parametrize("case", ["sine_passes", "flagged_24bit_raises"])
def test_dense_verify_matches_flac_tpu(monkeypatch, case):
    """Dense verify decodes flac_tpu's byte rows (the first nframes frames,
    maxb bytes each, zero past each frame). On a sine it passes; on the
    near-silent 24-bit frames with full-scale spikes of
    tests/test_torch_verify_flagged.py, whose Rice outliers the narrow scan
    flags, both packages raise the same VerifyError (ROADMAP queue 3)."""
    monkeypatch.delenv("FLAC_TPU_PACKER", raising=False)
    if case == "sine_passes":
        bps, sig = 16, make_signal(T * 4 + 11, 2, 16, kind="sine", seed=78)
        ref = _encode_jax(sig, True, verify=True)
        got, _ = _encode_torch(sig, monkeypatch, True, verify=True)
        assert got == ref
        return
    bps, rng = 24, np.random.default_rng(3)
    amp = (1 << 23) - 1
    x = rng.integers(-3, 4, (4 * T, 2)).astype(np.int32)
    x[rng.integers(0, len(x), 40)] = rng.integers(-amp - 1, amp + 1, (40, 2)).astype(np.int32)
    with pytest.raises(j_enc.VerifyError) as jerr:
        _encode_jax(x, True, bps=bps, verify=True)
    with pytest.raises(t_enc.VerifyError) as terr:
        _encode_torch(x, monkeypatch, True, bps=bps, verify=True)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.cuda
def test_cuda_compaction_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for words, total_bits, _ in [*CASES, (*_real_batch(), None)]:
        w = torch.as_tensor(words, device="cuda")
        tb = torch.as_tensor(total_bits, device="cuda")
        before = compact_stream.launches
        got = t_packer.compact_stream_words_kernel(w, tb)
        assert compact_stream.launches == before + 1
        ref = t_packer.compact_stream_words(w, tb)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
