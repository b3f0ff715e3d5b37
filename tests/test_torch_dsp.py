"""The port's DSP, Rice and config against flac_tpu, function by function.

The same numpy inputs (from a seed) go through the jitted flac_tpu function
(JAX on the CPU, x64 on, as tier-1 runs it) and its flac_tpu_torch
counterpart on the CPU. Integer results must be equal. Tolerances, each for
a float stage: autocorrelation rtol=1e-5 (float32 sums may be taken in
another order), levinson rtol=1e-12 (float64, same autoc in; eager JAX,
see the test), and the
log-based estimators rtol=1e-12 (float64 log implementations may differ in
the last bit). quantize_coefficients gets the same float inputs and must be
exact.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu import rice as j_rice
from flac_tpu.dsp import bitmath as j_bitmath
from flac_tpu.dsp import fixed as j_fixed
from flac_tpu.dsp import lpc as j_lpc
from flac_tpu.dsp import signal as j_signal
from flac_tpu.dsp import windows as j_windows
from flac_tpu.encode import frame_encoder as j_fe
from flac_tpu.encode import packer as j_packer
from flac_tpu_torch import rice as t_rice
from flac_tpu_torch.dsp import bitmath as t_bitmath
from flac_tpu_torch.dsp import fixed as t_fixed
from flac_tpu_torch.dsp import lpc as t_lpc
from flac_tpu_torch.dsp import signal as t_signal
from flac_tpu_torch.dsp import windows as t_windows
from flac_tpu_torch.encode import frame_encoder as t_fe
from flac_tpu_torch.encode import packer as t_packer

T = 1024
MAXORD = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.array(x)


def _signal(seed=0, shape=(2, 4)):
    """int32 [..., T] frames: correlated music-like, a constant and a zero
    frame, wasted bits and full-scale noise, so every branch is taken."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, 300, shape + (T,)), axis=-1)
    x = np.clip(np.round(x), -32768, 32767).astype(np.int32)
    x[0, 1] = 1234
    x[1, 0] = 0
    x[1, 1] = (x[1, 1] >> 3) << 3
    x[1, 2] = rng.integers(-65536, 65535, size=T)
    return x


def _autoc(x):
    """Windowed float32 autocorrelation input, as the encoder forms it."""
    win = j_windows.make_window_bank((("tukey", 0.5),), T)
    return (x.astype(np.float32)[..., None, :] * win).astype(np.float32)


def _cases():
    x = _signal()
    rng = np.random.default_rng(1)
    folded = rng.integers(0, 1 << 20, size=(2, 4, T)).astype(np.int64)
    cases = {
        "wasted_bits": (lambda m: m.wasted_bits, (x,), {}),
        "is_constant": (lambda m: m.is_constant, (x,), {}),
        "mid_side": (lambda m: m.mid_side, (x[:, 0], x[:, 1]), {}),
        "popcount32": (lambda m: m._popcount32,
                       (rng.integers(-2 ** 31, 2 ** 31, 200).astype(np.int32),), {}),
        "bitlen64": ("bitmath", lambda m: m.bitlen64,
                     (rng.integers(0, 2 ** 62, 300),), {}),
        "bitlen32": ("bitmath", lambda m: m.bitlen64,
                     (rng.integers(0, 2 ** 31, 300).astype(np.int32),), {}),
        "ilog2": ("bitmath", lambda m: m.ilog2, (rng.integers(1, 2 ** 40, 300),), {}),
        "frexp_exponent": ("bitmath", lambda m: m.frexp_exponent,
                           (np.abs(rng.normal(0, 10, 300)) + 1e-6,), {}),
        "fixed_errors_narrow": ("fixed", lambda m: m.fixed_errors, (x,), {"wide": False}),
        "fixed_errors_wide": ("fixed", lambda m: m.fixed_errors, (x,), {"wide": True}),
        "fixed_residuals": ("fixed", lambda m: m.fixed_residuals_all_orders, (x,), {}),
        "fold_narrow": ("rice", lambda m: m.fold_residual,
                        (rng.integers(-2 ** 31, 2 ** 31, 500).astype(np.int32),),
                        {"narrow": True}),
        "fold_wide": ("rice", lambda m: m.fold_residual,
                      (rng.integers(-2 ** 40, 2 ** 40, 500),), {}),
        "rice_exact_bits": ("rice", lambda m: m.rice_exact_bits,
                            (folded, rng.integers(0, 15, size=(2, 4, 32)).astype(np.int32),
                             None, rng.integers(0, 9, size=(2, 4)).astype(np.int32),
                             rng.integers(0, 6, size=(2, 4)).astype(np.int32), T, 5), {}),
    }
    return cases


_CASES = _cases()
_MODS = {"signal": (j_signal, t_signal), "bitmath": (j_bitmath, t_bitmath),
         "fixed": (j_fixed, t_fixed), "rice": (j_rice, t_rice)}


def _jit_call(fn, args, kwargs):
    """Call a flac_tpu function under jit, array arguments traced and the
    rest static, as the encoder runs it."""
    arr_pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def wrapped(*arrs):
        full = list(args)
        for i, a in zip(arr_pos, arrs):
            full[i] = a
        return fn(*full, **kwargs)

    return jax.jit(wrapped)(*[jnp.array(args[i]) for i in arr_pos])


def _torch_call(fn, args, kwargs):
    return fn(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                for a in args], **kwargs)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_integer_function_matches(name):
    spec = _CASES[name]
    mod = "signal"
    if isinstance(spec[0], str):
        mod, spec = spec[0], spec[1:]
    get, args, kwargs = spec
    jm, tm = _MODS[mod]
    ref = _jit_call(get(jm), args, kwargs)
    got = _torch_call(get(tm), args, kwargs)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(g), _np(r))


def test_residual_bits_per_sample():
    errs, _ = j_fixed.fixed_errors(jnp.array(_signal()), False)
    ref = jax.jit(j_fixed.residual_bits_per_sample, static_argnums=1)(errs, T - 4)
    got = t_fixed.residual_bits_per_sample(torch.as_tensor(np.array(errs)), T - 4)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-12)


def test_rice_search_matches():
    x = _signal()
    res = np.array(j_fixed.fixed_residuals_all_orders(jnp.array(x)))
    orders = np.broadcast_to(np.arange(5, dtype=np.int32), res.shape[:-1]).copy()
    valid = np.arange(T) >= orders[..., None]
    absres = np.where(valid, np.abs(res), 0).astype(np.int32)
    folded = np.where(valid, (res << 1) ^ (res >> 31), 0).astype(np.int32)
    sugg = np.random.default_rng(2).integers(1, 15, size=orders.shape).astype(np.int32)
    for max_po, min_po in ((5, 0), (3, 2), (0, 0)):
        ref = jax.jit(j_rice.rice_search, static_argnums=(4, 5, 6, 7))(
            jnp.array(absres), jnp.array(folded), jnp.array(orders),
            jnp.array(sugg), T, min_po, max_po, 15)
        got = t_rice.rice_search(torch.as_tensor(absres), torch.as_tensor(folded),
                                 torch.as_tensor(orders), torch.as_tensor(sugg),
                                 T, min_po, max_po, 15)
        for f in ref._fields:
            np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(ref, f)),
                                          err_msg=f"{f} at po {min_po}..{max_po}")


def _lpc_chain_inputs():
    xw = _autoc(_signal())
    autoc = np.array(jax.jit(j_lpc.autocorrelation, static_argnums=1)(
        jnp.array(xw), MAXORD))
    return xw, autoc


def test_autocorrelation_close():
    xw, ref = _lpc_chain_inputs()
    got = t_lpc.autocorrelation(torch.as_tensor(xw), MAXORD)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5)


@pytest.mark.parametrize("n", [17, 32, 33, 777])
def test_autocorrelation_short_and_partial_blocks_close(n):
    xw = _autoc(_signal())[..., :n]
    ref = jax.jit(j_lpc.autocorrelation, static_argnums=1)(jnp.array(xw), MAXORD)
    got = t_lpc.autocorrelation(torch.as_tensor(xw), MAXORD)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5)


def test_levinson_close():
    """Against flac_tpu's levinson run eagerly: under jit, XLA:CPU contracts
    its float64 mul+adds into FMAs, which moves ill-conditioned frames (the
    constant one here) by ~1e-6 relative (ROADMAP queue 3)."""
    _, autoc = _lpc_chain_inputs()
    ref = j_lpc.levinson(jnp.array(autoc), MAXORD)
    got = t_lpc.levinson(torch.as_tensor(autoc), MAXORD)
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), rtol=1e-12)
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), rtol=1e-12)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))


def test_order_estimators():
    _, autoc = _lpc_chain_inputs()
    _, lerr, lvalid = (np.array(a) for a in j_lpc.levinson(jnp.array(autoc), MAXORD))
    overhead = np.full(lerr.shape[:-1], 16 + 12, np.float64)
    ref = jax.jit(j_lpc.compute_best_order, static_argnums=2)(
        jnp.array(lerr), jnp.array(lvalid), T, jnp.array(overhead))
    got = t_lpc.compute_best_order(torch.as_tensor(lerr), torch.as_tensor(lvalid),
                                   T, torch.as_tensor(overhead))
    np.testing.assert_array_equal(_np(got), _np(ref))
    tot = np.full(lerr.shape, float(T - 3))
    ref = jax.jit(j_lpc.expected_bits_per_residual_sample)(jnp.array(lerr),
                                                           jnp.array(tot))
    got = t_lpc.expected_bits_per_residual_sample(torch.as_tensor(lerr),
                                                  torch.as_tensor(tot))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-12)
    rb = np.random.default_rng(4).uniform(-1, 20, 400)
    np.testing.assert_array_equal(
        _np(t_fe._suggested_param(torch.as_tensor(rb), 15)),
        _np(jax.jit(j_fe._suggested_param, static_argnums=1)(jnp.array(rb), 15)))


def test_quantize_and_lpc_residual_match():
    rng = np.random.default_rng(5)
    x = _signal()
    _, autoc = _lpc_chain_inputs()
    coeffs = np.array(j_lpc.levinson(jnp.array(autoc), MAXORD)[0])  # [2,4,1,8,8]
    order = rng.integers(1, MAXORD + 1, size=(2, 4, 1, 1)).astype(np.int32)
    rows = np.take_along_axis(coeffs, (order - 1)[..., None], axis=-2)
    for prec in (5, 10, 12, 15):
        precision = np.full(order.shape, prec, np.int32)
        ref = jax.jit(j_lpc.quantize_coefficients, static_argnums=3)(
            jnp.array(rows), jnp.array(order), jnp.array(precision), MAXORD)
        got = t_lpc.quantize_coefficients(torch.as_tensor(rows), torch.as_tensor(order),
                                          torch.as_tensor(precision), MAXORD)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_np(g), _np(r))
        qlp, shift = np.array(ref[0]), np.array(ref[1])
        for narrow in (True, False):
            rref = jax.jit(j_lpc.lpc_residual, static_argnums=(4, 5))(
                jnp.array(x[:, :, None, None, :]), jnp.array(qlp),
                jnp.array(order), jnp.array(shift), MAXORD, narrow)
            rgot = t_lpc.lpc_residual(torch.as_tensor(x[:, :, None, None, :]),
                                      torch.as_tensor(qlp), torch.as_tensor(order),
                                      torch.as_tensor(shift), MAXORD, narrow)
            np.testing.assert_array_equal(_np(rgot), _np(rref))


def test_utf8_frame_number_fields():
    n = np.array([0, 1, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x1FFFFF,
                  0x200000, 0x3FFFFFF, 0x4000000, 0x7FFFFFFF, 0x80000000,
                  (1 << 36) - 1, (1 << 36)], np.int64)
    ref = jax.jit(j_fe._utf8_fields)(jnp.array(n))
    got = t_fe._utf8_fields(torch.as_tensor(n),
                            torch.tensor(t_fe._UTF8_THRESHOLDS, dtype=torch.int64))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(g), _np(r))


@pytest.mark.parametrize("level", range(9))
def test_config_and_static_tables_equal(level):
    """The codec's "weights": the resolved config and the static tables
    built from it."""
    for ch, bps, sr, bs in ((2, 16, 44100, None), (1, 24, 96000, 4608),
                            (2, 8, 8000, 1152)):
        jc = j_fe.EncoderConfig.from_level(level, ch, bps, sr, blocksize=bs)
        tc = t_fe.EncoderConfig.from_level(level, ch, bps, sr, blocksize=bs)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.rice_parameter_limit == jc.rice_parameter_limit
        assert tc.loose_mid_side_frames == jc.loose_mid_side_frames
        assert t_fe.EncoderConfig.from_dict(dataclasses.asdict(jc)) == tc
        T_ = tc.blocksize
        assert t_fe.max_frame_bytes(tc, T_) == j_fe.max_frame_bytes(jc, T_)
        assert t_fe._header_static_codes(tc, T_) == j_fe._header_static_codes(jc, T_)
        np.testing.assert_array_equal(
            t_windows.make_window_bank(tc.apodizations, T_),
            j_windows.make_window_bank(jc.apodizations, T_))
        maxwords = t_fe.max_frame_bytes(tc, T_) // 4
        for tt, jt in zip(t_packer.crc16_word_tables(maxwords),
                          j_packer.crc16_word_tables(maxwords)):
            np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(t_packer.xpow_table_np(1024, 0x07, 8),
                                  j_packer.xpow_table_np(1024, 0x07, 8))


# --- the decode side: lpc_restore, fixed_restore, undo_channel_assignment ---


def _restore_case(seed, max_order, B=6, T=300):
    """Residuals, coefficients, orders (1..max_order), shifts and warmup
    from a seed; the last row's coefficients are large enough for the
    int64 history to wrap, which both packages do alike."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-3000, 3000, (B, T)).astype(np.int32)
    qlp = rng.integers(-600, 600, (B, max_order)).astype(np.int32)
    qlp[-1] = rng.integers(-(1 << 14), 1 << 14, max_order)
    order = rng.integers(1, max_order + 1, B).astype(np.int32)
    shift = rng.integers(0, 16, B).astype(np.int32)
    warm = rng.integers(-30000, 30000, (B, max_order)).astype(np.int32)
    return res, qlp, order, shift, warm


@pytest.mark.parametrize("seed,max_order", [(0, 8), (1, 32), (2, 1)])
def test_lpc_restore_matches(seed, max_order):
    args = _restore_case(seed, max_order)
    ref = _jit_call(j_lpc.lpc_restore, (*args, max_order), {})
    got = _torch_call(t_lpc.lpc_restore, (*args, max_order), {})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("order", range(5))
def test_fixed_restore_matches(order):
    rng = np.random.default_rng(10 + order)
    res = rng.integers(-40000, 40000, (2, 3, T - order)).astype(np.int32)
    warm = rng.integers(-32768, 32768, (2, 3, order)).astype(np.int32)
    ref = _jit_call(j_fixed.fixed_restore, (res, warm, order), {})
    got = _torch_call(t_fixed.fixed_restore, (res, warm, order), {})
    assert got.dtype == torch.int32 and got.shape == (2, 3, T)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("assignment", range(4))
def test_undo_channel_assignment_matches(assignment):
    """One assignment for every frame, then all four mixed over the batch."""
    x = _signal(seed=assignment)
    mid, side = x[:, 0], x[:, 1]
    a = np.full(2, assignment, np.int32)
    mixed = np.arange(4, dtype=np.int32)
    for ch0, ch1, asg in ((mid, side, a), (x[0], x[1], mixed)):
        ref = _jit_call(j_signal.undo_channel_assignment, (ch0, ch1, asg), {})
        got = _torch_call(t_signal.undo_channel_assignment, (ch0, ch1, asg), {})
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_np(g), _np(r))
