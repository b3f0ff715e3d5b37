"""The port's wide encode datapath against flac_tpu, on the CPU.

Streams with bps + log2(T) + 1 > 30 take the wide datapath
(stream_encoder.c:888): the 24-bit family through the two-int32-limb LPC
residual, wider streams through int64. Held against flac_tpu (JAX on the
CPU, jitted):

- `lpc_residual_limbs`: res and ovf (ovf masks a candidate out of the
  search, so a different ovf is a different stream) on 25-bit inputs over
  precisions 5-15, orders 1-12 and shifts on both sides of 12, with
  candidates whose ovf trips;
- `lpc_residual(narrow=False)` (int64 accumulation, int32 truncation) on
  28- to 32-bit inputs; `fixed_errors(wide=True)` and
  `fold_residual(narrow=False)` at 24 and 32 bits;
- `build_frame_encoder` at level 5 on 28-bit (mid-side on: a 29-bit side
  channel, the int64 LPC path) and 32-bit (mid-side off, 32-bit verbatim
  fields) stereo: words, bit counts and every info array.

Equality throughout: every output is an integer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_signal
from flac_tpu import rice as j_rice
from flac_tpu.dsp import fixed as j_fixed
from flac_tpu.dsp import lpc as j_lpc
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu_torch import rice as t_rice
from flac_tpu_torch.dsp import fixed as t_fixed
from flac_tpu_torch.dsp import lpc as t_lpc
from flac_tpu_torch.encode import frame_encoder as t_fe

T = 1024
MAXORD = 12


def _signal(bits: int, n: int = 512, frames: int = 3, seed: int = 0) -> np.ndarray:
    """int32 [frames, n] frames at `bits` bits: a smooth random walk (LPC
    predicts it well), full-scale noise, and a square wave at the rails."""
    rng = np.random.default_rng(seed)
    hi = (1 << (bits - 1)) - 1
    walk = np.cumsum(rng.normal(0, hi / 64, (frames, n)), axis=-1)
    x = np.clip(np.round(walk), -hi - 1, hi)
    x[1] = rng.integers(-hi - 1, hi + 1, n)
    x[2] = np.where((np.arange(n) // 16) % 2 == 0, hi, -hi - 1)
    return x.astype(np.int64).astype(np.int32)


def _candidates(seed: int = 1):
    """Every (precision 5-15, order 1-12) pair, with a random shift in
    [0, 15] and random coefficients of that precision; a quarter of them
    at full-scale coefficients, to push the s < 12 sums out of int32."""
    rng = np.random.default_rng(seed)
    prec, order = np.meshgrid(np.arange(5, 16), np.arange(1, MAXORD + 1), indexing="ij")
    prec, order = prec.ravel(), order.ravel()
    n = len(prec)
    top = (1 << (prec - 1))[:, None]
    qlp = rng.integers(-top, top, (n, MAXORD))
    loud = rng.random(n) < 0.25
    qlp[loud] = np.where(rng.random((int(loud.sum()), MAXORD)) < 0.5, -top[loud], top[loud] - 1)
    qlp = np.where(np.arange(MAXORD) < order[:, None], qlp, 0).astype(np.int32)
    shift = rng.integers(0, 16, n).astype(np.int32)
    # [1, n] candidates against [frames, 1] signals, as the encoder lays them
    return qlp[None], order.astype(np.int32)[None], shift[None]


def test_lpc_residual_limbs_matches():
    x = _signal(25)[:, None, :]                            # [3, 1, 512]
    qlp, order, shift = _candidates()
    f = jax.jit(j_lpc.lpc_residual_limbs, static_argnums=4)
    jr, jo = f(jnp.asarray(x), jnp.asarray(qlp), jnp.asarray(order),
               jnp.asarray(shift), MAXORD)
    tr, to = t_lpc.lpc_residual_limbs(torch.as_tensor(x), torch.as_tensor(qlp),
                                      torch.as_tensor(order), torch.as_tensor(shift),
                                      MAXORD)
    jo = np.asarray(jo)
    assert jo.any() and not jo.all()   # some candidates trip, some do not
    assert (shift[0, jo.any(axis=0)] < 12).all() and (shift >= 12).any()
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("bits", [28, 29, 31, 32])
def test_lpc_residual_int64_accumulation_matches(bits):
    x = _signal(bits, seed=bits)[:, None, :]
    qlp, order, shift = _candidates(seed=bits)
    f = jax.jit(j_lpc.lpc_residual, static_argnums=(4, 5))
    ref = f(jnp.asarray(x), jnp.asarray(qlp), jnp.asarray(order), jnp.asarray(shift),
            MAXORD, False)
    got = t_lpc.lpc_residual(torch.as_tensor(x), torch.as_tensor(qlp),
                             torch.as_tensor(order), torch.as_tensor(shift), MAXORD,
                             narrow=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bits", [24, 32])
def test_wide_fixed_errors_and_fold_match(bits):
    x = _signal(bits, seed=bits)
    jerr, jord = jax.jit(j_fixed.fixed_errors, static_argnums=1)(jnp.asarray(x), True)
    terr, tord = t_fixed.fixed_errors(torch.as_tensor(x), True)
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(tord.numpy(), np.asarray(jord))
    res = t_fixed.fixed_residuals_all_orders(torch.as_tensor(x)).numpy()
    jfold = jax.jit(j_rice.fold_residual, static_argnums=1)(jnp.asarray(res), False)
    tfold = t_rice.fold_residual(torch.as_tensor(res), narrow=False)
    np.testing.assert_array_equal(tfold.numpy(), np.asarray(jfold))


def _tonal(bps: int, seed: int, noise_frame: bool = True) -> np.ndarray:
    """[4, T, 2] frames of two sines and noise at `bps` bits, which LPC
    predicts best, with frame 1 full-scale noise (verbatim) unless not
    `noise_frame`."""
    rng = np.random.default_rng(seed)
    t = np.arange(4 * T)
    amp = (1 << (bps - 1)) - 1
    x = np.stack([0.5 * amp * np.sin(2 * np.pi * 441 * (c + 1) * t / 44100)
                  + 0.2 * amp * np.sin(2 * np.pi * 1234.5 * t / 44100)
                  + rng.normal(0, 2.0 ** (bps - 12), len(t)) for c in range(2)], axis=1)
    x = np.clip(np.round(x), -amp - 1, amp).astype(np.int64).astype(np.int32)
    if noise_frame:
        x[T:2 * T] = make_signal(T, 2, bps, kind="noise", seed=seed)
    return x.reshape(4, T, 2)


def _frame_encoders_match(bps, rate, pcm, **overrides):
    B = pcm.shape[0]
    jc = j_fe.EncoderConfig.from_level(5, 2, bps, rate, blocksize=T, **overrides)
    tc = t_fe.EncoderConfig.from_level(5, 2, bps, rate, blocksize=T, **overrides)
    fnos = np.arange(B, dtype=np.int64)
    jw, jt, jinfo = j_fe.build_frame_encoder(jc, packer_impl="xla")(pcm, fnos)
    tw, tt, tinfo = t_fe.build_frame_encoder(tc, device="cpu")(pcm, fnos)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    return tinfo


@pytest.mark.parametrize("bps", [28, 32])
def test_wide_frame_encoder_matches(bps):
    info = _frame_encoders_match(bps, 44100, _tonal(bps, seed=bps))
    assert (info["subframe_type"] == 3).any()  # the int64 LPC path chose LPC
    assert (info["subframe_type"] == 1).any()  # and the noise frame verbatim
