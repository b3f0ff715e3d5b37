"""Escape coding in the port against flac_tpu, on the CPU.

`rice_search(do_escape=True)` and `rice_exact_bits` with escaped leaves must
give flac_tpu's results on int32 and int64 residuals with near-silent
partitions and spikes; the frame encoder with `do_escape_coding=True` must
give flac_tpu's words, bit counts and choices on tests/test_escape.py's
burst signal at 16 bits (RICE, escape parameter 15) and 24 bits (RICE2,
escape parameter 31), and `encode_file` the same bytes, with escaped
partitions in them, verified and lossless. Equality throughout: every
output is an integer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu import rice as j_rice
from flac_tpu.encode import encoder as j_enc
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu_torch import rice as t_rice
from flac_tpu_torch.decode.host_decoder import HostDecoder
from flac_tpu_torch.encode import encoder as t_enc
from flac_tpu_torch.encode import frame_encoder as t_fe
from test_escape import _burst_signal

T = 1024
MAX_PO = 5


def _residuals(wide: bool, seed: int = 4):
    """[2, 3, T] residuals: near-silent rows (|r| <= 3) with full-scale
    bursts in a few partitions and lone spikes elsewhere, int32 (the 32-bit
    datapath) or int64 (the wide one, past 2^31), with the encoder's masks
    (zeros before each row's order) applied to |r| and the fold."""
    rng = np.random.default_rng(seed)
    top = 1 << (34 if wide else 30)
    r = rng.integers(-3, 4, (2, 3, T))
    r[0, 0, 96:160] = rng.integers(-top, top, 64)          # a burst in leaves 3-4
    r[1, 2, 512:544] = rng.integers(-(1 << 20), 1 << 20, 32)
    for b, k, t in rng.integers(0, (2, 3, T), (12, 3)):
        r[b, k, t] = rng.integers(-top, top)               # lone spikes
    r[1, 1] = 0                                            # an all-zero row
    order = rng.integers(0, 13, (2, 3)).astype(np.int32)
    valid = np.arange(T) >= order[..., None]
    if wide:
        absres = np.where(valid, np.abs(r), 0).astype(np.int64)
        folded = np.where(valid, np.where(r >= 0, r << 1, (-r << 1) - 1), 0)
    else:
        r = r.astype(np.int32)
        absres = np.where(valid, np.abs(r), 0).astype(np.int32)
        folded = np.where(valid, (r << 1) ^ (r >> 31), 0).astype(np.int32)
    sugg = rng.integers(1, 15, (2, 3)).astype(np.int32)
    return absres, folded, order, sugg


@pytest.mark.parametrize("wide,limit", [(False, 15), (False, 31), (True, 31)])
def test_rice_search_with_escapes_matches(wide, limit):
    absres, folded, order, sugg = _residuals(wide)
    escaped = 0
    for min_po, max_po in ((0, MAX_PO), (2, 4), (0, 0)):
        ref = jax.jit(j_rice.rice_search, static_argnums=(4, 5, 6, 7, 8))(
            jnp.array(absres), jnp.array(folded), jnp.array(order),
            jnp.array(sugg), T, min_po, max_po, limit, True)
        got = t_rice.rice_search(torch.as_tensor(absres), torch.as_tensor(folded),
                                 torch.as_tensor(order), torch.as_tensor(sugg),
                                 T, min_po, max_po, limit, do_escape=True)
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"{f} at po {min_po}..{max_po}")
        escaped += int((got.raw_bits_leaf > 0).sum())
    assert escaped > 0  # the bursts and spikes took the escape


@pytest.mark.parametrize("wide", [False, True])
def test_rice_exact_bits_with_raw_leaves_matches(wide):
    _, folded, order, _ = _residuals(wide, seed=7)
    rng = np.random.default_rng(8)
    po = rng.integers(0, MAX_PO + 1, (2, 3)).astype(np.int32)
    params = rng.integers(0, 31, (2, 3, 1 << MAX_PO)).astype(np.int32)
    # raw widths per partition of the chosen order, 0 where not escaped
    raw = np.zeros_like(params)
    for b in range(2):
        for k in range(3):
            span = 1 << (MAX_PO - po[b, k])
            for p in range(1 << po[b, k]):
                if rng.random() < 0.4:
                    raw[b, k, p * span:(p + 1) * span] = rng.integers(1, 32)
                    params[b, k, p * span:(p + 1) * span] = 0
    ref = jax.jit(j_rice.rice_exact_bits, static_argnums=(5, 6))(
        jnp.array(folded), jnp.array(params), jnp.array(raw), jnp.array(order),
        jnp.array(po), T, MAX_PO)
    got = t_rice.rice_exact_bits(torch.as_tensor(folded), torch.as_tensor(params),
                                 torch.as_tensor(raw), torch.as_tensor(order),
                                 torch.as_tensor(po), T, MAX_PO)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _escaped_partitions(data: bytes) -> int:
    _, frames = HostDecoder(data).decode_all()
    return sum(p == -1 for f in frames for s in f.subframes for p in s.rice_params)


@pytest.mark.parametrize("bps,rate", [(16, 44100), (24, 96000)])
def test_escape_encode_matches_flac_tpu(tmp_path, bps, rate):
    """Four frames of the burst signal, the burst inside frame 0: the
    frame encoder's outputs, then encode_file's bytes (the same build and
    batch on the flac_tpu side), with escaped partitions, verify passing
    and a lossless decode by the port's host decoder."""
    sig = _burst_signal(8 * T, bps, seed=5 if bps == 16 else 11)[4 * T:]
    kw = dict(blocksize=T, do_escape_coding=True)
    jc = j_fe.EncoderConfig.from_level(5, 2, bps, rate, **kw)
    tc = t_fe.EncoderConfig.from_level(5, 2, bps, rate, **kw)
    pcm, fnos = sig.reshape(4, T, 2), np.arange(4, dtype=np.int64)
    # the default packer off the TPU is the plain one, and this build is the
    # one encode_file below reuses
    jw, jt, jinfo = j_fe.build_frame_encoder(jc)(pcm, fnos)
    tw, tt, tinfo = t_fe.build_frame_encoder(tc, device="cpu")(pcm, fnos)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    jp, tp = tmp_path / "j.flac", tmp_path / "t.flac"
    j_enc.encode_file(sig, rate, bps, str(jp), level=5, batch_frames=4, **kw)
    t_enc.encode_file(sig, rate, bps, str(tp), level=5, batch_frames=4, verify=True,
                      device="cpu", **kw)
    data = tp.read_bytes()
    assert data == jp.read_bytes()
    assert _escaped_partitions(data) > 0
    pcm_out, frames = HostDecoder(data).decode_all()
    np.testing.assert_array_equal(pcm_out, sig)
