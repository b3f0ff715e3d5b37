"""The port's dense stream path against flac_tpu's, on the CPU.

The plain compaction (`compact_stream_words`, `compact_stream_bytes`) is
held against flac_tpu's jitted one bit for bit, on the four generated cases
of tests/test_dense_path.py::TestCompaction (seed 123) and on a real level-5
batch. `StreamEncoder`, which takes the dense route on every device, must
write flac_tpu's dense bytes (flac_tpu's encoder forced onto its dense
route as tests/test_dense_path.py forces it), seektable included, and its
verify must pass where flac_tpu's dense verify passes, and on the frames
the scan flags, where flac_tpu's raises. The CUDA kernel is held against
the plain version on the card (`-m cuda`, and chip_smoke.py)."""

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
from flac_tpu_torch.kernels._build import KernelError

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


def _encode_jax(sig, dense, bps=16, **kw):
    """flac_tpu's StreamEncoder, forced dense as tests/test_dense_path.py
    forces it."""
    cfg = j_fe.EncoderConfig.from_level(5, channels=sig.shape[1], bits_per_sample=bps,
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


def _encode_torch(sig, bps=16, **kw):
    """The port's StreamEncoder on the CPU (the dense route, as on every
    device)."""
    cfg = t_fe.EncoderConfig.from_level(5, channels=sig.shape[1], bits_per_sample=bps,
                                        sample_rate=44100, blocksize=T)
    out = io.BytesIO()
    enc = t_enc.StreamEncoder(cfg, out, batch_frames=4, total_samples_estimate=len(sig),
                              device="cpu", **kw)
    enc.process(sig)
    enc.finish()
    return out.getvalue(), enc.stats


def _check_dense_bytes(sig, bps=16, **kw):
    """Batches of 4 and 2 frames and a partial frame: the port's bytes equal
    flac_tpu's dense ones. Returns them."""
    ref = _encode_jax(sig, True, bps=bps, **kw)
    before = compact_stream.launches
    dense, stats = _encode_torch(sig, bps=bps, **kw)
    assert dense == ref
    assert stats.batches == 3 and stats.frames == 7
    assert compact_stream.launches == before  # the CPU takes the plain compaction
    return dense


def test_dense_stream_encoder_bytes_match():
    """_check_dense_bytes on a quiet stereo signal, seektable filled."""
    sig = make_signal(T * 6 + 321, 2, 16, kind="quiet", seed=77)
    _check_dense_bytes(sig, seekpoints=[0, 2048, 5000])


@pytest.mark.parametrize("case", ["near_silent_8bit_mono", "constant_stereo"])
def test_dense_stream_encoder_bytes_match_tiny_frames(case):
    """_check_dense_bytes on signals whose frames are 10 to 150 bytes
    (constant subframes, one-bit residuals): the frames that the
    compaction's output-driven grid packs many to a chunk on the card."""
    if case == "near_silent_8bit_mono":
        bps, rng = 8, np.random.default_rng(79)
        sig = np.zeros((T * 6 + 97, 1), np.int32)
        sig[rng.integers(2 * T, len(sig), 12), 0] = rng.choice([-1, 1], 12)
    else:
        bps, sig = 16, make_signal(T * 6 + 97, 2, 16, kind="constant")
    dense = _check_dense_bytes(sig, bps=bps)
    # STREAMINFO's max framesize: tens of frames to a 2,048-byte chunk
    max_frame_bytes = int.from_bytes(dense[15:18], "big")
    assert 0 < max_frame_bytes < (160 if case == "near_silent_8bit_mono" else 32)


@pytest.mark.parametrize("case", ["sine_passes", "flagged_24bit_port_verifies"])
def test_dense_verify_matches_flac_tpu(case):
    """Dense verify decodes flac_tpu's byte rows (the first nframes frames,
    maxb bytes each, zero past each frame). On a sine it passes. On the
    near-silent 24-bit frames with full-scale spikes of
    tests/test_torch_verify_flagged.py, whose Rice outliers the narrow scan
    flags, flac_tpu raises VerifyError (ROADMAP queue 3); the port decodes
    the flagged frames on the host, verifies the stream and writes
    flac_tpu's dense verify=False bytes."""
    if case == "sine_passes":
        bps, sig = 16, make_signal(T * 4 + 11, 2, 16, kind="sine", seed=78)
        ref = _encode_jax(sig, True, verify=True)
        got, _ = _encode_torch(sig, verify=True)
        assert got == ref
        return
    bps, rng = 24, np.random.default_rng(3)
    amp = (1 << 23) - 1
    x = rng.integers(-3, 4, (4 * T, 2)).astype(np.int32)
    x[rng.integers(0, len(x), 40)] = rng.integers(-amp - 1, amp + 1, (40, 2)).astype(np.int32)
    with pytest.raises(j_enc.VerifyError):
        _encode_jax(x, True, bps=bps, verify=True)
    before = t_enc.verify_host_frames
    got, stats = _encode_torch(x, bps=bps, verify=True)
    assert got == _encode_jax(x, True, bps=bps)
    assert t_enc.verify_host_frames - before >= 1 and stats.frames == 4


@pytest.mark.cuda
def test_cuda_compaction_kernel_matches_plain_on_card():
    """The kernel against the plain version on TestCompaction's cases, a
    real batch and test_torch_compact_layout.py's edge cases of the
    output-driven decomposition; a batch of more frames than its shared
    memory holds raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from test_torch_compact_layout import edge_cases
    for words, total_bits, _ in [*CASES, (*_real_batch(), None),
                                 *((w, tb, None) for w, tb in edge_cases().values())]:
        w = torch.as_tensor(words, device="cuda")
        tb = torch.as_tensor(total_bits, device="cuda")
        before = compact_stream.launches
        got = t_packer.compact_stream_words_kernel(w, tb)
        assert compact_stream.launches == before + 1
        ref = t_packer.compact_stream_words(w, tb)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
    # more frames than the kernel's shared memory holds: refused
    too_many = compact_stream._lib().flac_compact_stream_max_frames() + 1
    with pytest.raises(KernelError):
        compact_stream.compact_stream(torch.zeros((too_many, 1), dtype=torch.int32,
                                                  device="cuda"),
                                      torch.full((too_many,), 32, dtype=torch.int32,
                                                 device="cuda"))


@pytest.mark.cuda
def test_cuda_graphed_steps_equal_the_eager_parts():
    """On the card the encode steps run a shape's first call eagerly,
    capture at the second and replay from the third: every call equals
    build_frame_encoder_parts (then the compaction) on the same batch, int16
    and int32 PCM alike; an output kept from one call is unchanged by the
    next; pack and the compaction count one launch a call, replays
    included. A step whose capture reads a device value on the host raises
    KernelError naming the step, and the card goes on working."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from flac_tpu_torch import graphs
    from flac_tpu_torch.kernels import pack_words
    cfg = t_fe.EncoderConfig.from_level(5, 2, 16, 44100, blocksize=T)
    sig = make_signal(20 * T, 2, 16, kind="sine", seed=5)
    sig = sig + np.random.default_rng(5).integers(-300, 300, sig.shape).astype(np.int32)
    batches = [b.astype(np.int16) if i % 2 else b for i, b in
               enumerate(np.clip(sig, -32768, 32767).reshape(5, 4, T, 2))]
    fields_fn, pack_fn = t_fe.build_frame_encoder_parts(cfg, device="cuda")
    for build in (t_fe.build_frame_encoder, t_fe.build_frame_encoder_dense):
        assert build(cfg, device="cuda").device.type == "cuda"
    # fresh steps around the built steps' eager functions: call 1 at each shape
    # runs eagerly, whatever ran before in this process
    full = graphs.GraphedStep(t_fe.build_frame_encoder(cfg, device="cuda").fn, "full", "cuda")
    dense = graphs.GraphedStep(t_fe.build_frame_encoder_dense(cfg, device="cuda").fn,
                               "dense", "cuda")
    kept = []
    since = (graphs.eager_calls, graphs.captures, graphs.replays)
    for i in range(5):
        pcm = batches[i]
        fnos = np.arange(4 * i, 4 * i + 4, dtype=np.int64)
        w_ref, tb_ref = pack_fn(*fields_fn(pcm.astype(np.int32), fnos)[:2])
        s_ref, tot_ref = t_packer.compact_stream_words_kernel(w_ref, tb_ref)
        before = (pack_words.launches, compact_stream.launches)
        w, tb, info = full(pcm, fnos)
        s, tot, tb2, _ = dense(pcm, fnos)
        assert (pack_words.launches, compact_stream.launches) == (before[0] + 2,
                                                                  before[1] + 1)
        torch.cuda.synchronize()
        assert torch.equal(w, w_ref) and torch.equal(tb, tb_ref) and torch.equal(tb2, tb_ref)
        assert torch.equal(info["frame_bits"], tb_ref)
        assert torch.equal(s, s_ref) and int(tot) == int(tot_ref)
        # every output kept from an earlier call is as it was
        assert all(torch.equal(a, b) and a.data_ptr() != s.data_ptr() for a, b in kept)
        kept.append((s, s.clone()))
    # int32 batches at calls 0, 2, 4 and int16 ones at 1, 3: two shapes a
    # step, each step's calls eager, eager, capture, capture, replay
    counts = (graphs.eager_calls, graphs.captures, graphs.replays)
    assert tuple(a - b for a, b in zip(counts, since)) == (4, 4, 2)

    def reads_the_device(x):
        return x * int(x.sum().item())

    bad = graphs.GraphedStep(reads_the_device, "reads the device", "cuda")
    x = torch.arange(8, device="cuda")
    assert torch.equal(bad(x), x * 28)  # the eager first call
    with pytest.raises(KernelError, match="reads the device"):
        bad(x)
    w, tb, _ = full(batches[0], np.arange(4, dtype=np.int64))
    torch.cuda.synchronize()
    assert torch.equal(tb, pack_fn(*fields_fn(batches[0], np.arange(4))[:2])[1])
