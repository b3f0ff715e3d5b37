"""LPC analysis, batched over frames — the encode side of flac_tpu.dsp.lpc
(src/libFLAC/lpc.c:56-263 and the 32-bit residual at :265).

Every constant and arange carries the dtype flac_tpu gets under
jax_enable_x64 (float64 scalars, int64 aranges), so the two packages run the
same arithmetic, and the two-int32-limb wide residual
(`lpc_residual_limbs`) of the 24-bit family. The decode-side `lpc_restore`
runs the restore recurrence: on CUDA tensors the frame decoder's restore
kernel (csrc/restore_scan.cu), on CPU tensors the plain
`lpc_restore_plain`.
"""

from __future__ import annotations

import math

import torch

from flac_tpu_torch.dsp import bitmath
from flac_tpu_torch.kernels import restore_scan as _restore_scan

_LN2 = math.log(2.0)

# XLA:CPU's TreeReductionRewriter window: a float32 sum over more than this
# many elements runs as reduce-windows of 32 (zero-padded, low pad =
# pad // 2) down to one reduce of <= 32 elements.
_XLA_TREE_WINDOW = 32


def _sum_in_order(p: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis."""
    acc = p[..., 0]
    for i in range(1, p.shape[-1]):
        acc = acc + p[..., i]
    return acc


def _lag_product_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_t a[t] * b[t] in float32, in the order flac_tpu's jitted
    autocorrelation takes on XLA:CPU, so the CPU port gives the same bits.

    Longer than 32 elements, XLA materializes the products and sums them as
    a tree of 32-wide windows, each window left to right. Up to 32, the
    multiply fuses into the reduce and LLVM contracts it to a left-to-right
    chain of FMAs: emulated in float64, where the float32 product is exact.
    The same fixed order runs on CUDA (no reduction kernel is involved).
    """
    n = a.shape[-1]
    if n <= _XLA_TREE_WINDOW:
        acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
        for i in range(n):
            acc = (a[..., i].double() * b[..., i].double()
                   + acc.double()).float()
        return acc
    p = a * b
    while n > _XLA_TREE_WINDOW:
        padded = -(-n // _XLA_TREE_WINDOW) * _XLA_TREE_WINDOW
        lo = (padded - n) // 2
        p = torch.nn.functional.pad(p, (lo, padded - n - lo))
        p = _sum_in_order(p.reshape(p.shape[:-1] + (-1, _XLA_TREE_WINDOW)))
        n = padded // _XLA_TREE_WINDOW
    return _sum_in_order(p)


def autocorrelation(windowed: torch.Tensor, maxlag: int) -> torch.Tensor:
    """autoc[..., j] = sum_t d[t] * d[t+j], j = 0..maxlag (lpc.c:63).

    windowed: [..., T] float32 (already apodized). Accumulates in float32
    like the reference's FLAC__real path, in XLA:CPU's order (see
    _lag_product_sum).
    """
    T = windowed.shape[-1]
    cols = [_lag_product_sum(windowed[..., : T - j], windowed[..., j:])
            for j in range(maxlag + 1)]
    return torch.stack(cols, dim=-1)


def levinson(autoc: torch.Tensor, max_order: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Levinson-Durbin over all orders 1..max_order in float64 (lpc.c:112-154).

    Returns (lp_coeffs [..., L, L] float32 — row o-1 holds the predictor
    coefficients of order o; errors [..., L] float64; valid [..., L] bool —
    False for orders after the error hit 0.0, lpc.c:150-153).
    """
    a = autoc.to(torch.float64)
    batch = a.shape[:-1]
    L = max_order
    lpc = torch.zeros(batch + (L,), dtype=torch.float64, device=a.device)
    err = a[..., 0]
    rows, errs, valids = [], [], []
    alive = torch.ones(batch, dtype=torch.bool, device=a.device)
    for i in range(L):
        r = -a[..., i + 1]
        for j in range(i):
            r = r - lpc[..., j] * a[..., i - j]
        r = r / torch.where(err == 0.0, 1.0, err)  # guarded; masked by `alive`
        new_lpc = lpc.clone()
        new_lpc[..., i] = r
        half = i >> 1
        for j in range(half):
            tmp = new_lpc[..., j].clone()
            new_lpc[..., j] = new_lpc[..., j] + r * new_lpc[..., i - 1 - j]
            new_lpc[..., i - 1 - j] = new_lpc[..., i - 1 - j] + r * tmp
        if i & 1:
            new_lpc[..., half] = new_lpc[..., half] + new_lpc[..., half] * r
        new_err = err * (1.0 - r * r)
        lpc = torch.where(alive[..., None], new_lpc, lpc)
        err_out = torch.where(alive, new_err, err)
        rows.append(-lpc)  # negate FIR coeff to get predictor coeff (lpc.c:147)
        errs.append(err_out)
        valids.append(alive)
        err = err_out
        alive = alive & (err != 0.0)
    lp_coeffs = torch.stack(rows, dim=-2).to(torch.float32)
    return lp_coeffs, torch.stack(errs, dim=-1), torch.stack(valids, dim=-1)


def expected_bits_per_residual_sample(lpc_error: torch.Tensor,
                                      total_samples: torch.Tensor | float
                                      ) -> torch.Tensor:
    """FLAC__lpc_compute_expected_bits_per_residual_sample (lpc.c:1325-1351),
    float64."""
    error_scale = 0.5 * (_LN2 * _LN2) / torch.as_tensor(
        total_samples, dtype=torch.float64, device=lpc_error.device)
    bps = 0.5 * torch.log(error_scale * lpc_error) / _LN2
    # 1e32 as a float64 tensor: torch.where of two Python floats would round
    # it to the default float32, where flac_tpu (x64) keeps float64
    big = torch.full_like(bps, 1e32)
    return torch.where(lpc_error > 0.0, torch.clamp(bps, min=0.0),
                       torch.where(lpc_error < 0.0, big, 0.0))


def compute_best_order(errors: torch.Tensor, valid: torch.Tensor,
                       total_samples: int,
                       overhead_bits_per_order: torch.Tensor) -> torch.Tensor:
    """FLAC__lpc_compute_best_order (lpc.c:1353-1390): strict-< argmin of the
    estimated subframe bits over orders 1..L; ties keep the lower order
    (torch.argmin, like jnp.argmin, returns the first minimum).
    Returns the best order in 1..L as int32."""
    L = errors.shape[-1]
    orders = torch.arange(1, L + 1, dtype=torch.float64, device=errors.device)
    bits = (expected_bits_per_residual_sample(errors, float(total_samples))
            * (total_samples - orders)
            + orders * overhead_bits_per_order[..., None].to(torch.float64))
    bits = torch.where(valid, bits, math.inf)
    return (torch.argmin(bits, dim=-1) + 1).to(torch.int32)


def quantize_coefficients(lp_coeff: torch.Tensor, order: torch.Tensor,
                          precision: torch.Tensor, max_order: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FLAC__lpc_quantize_coefficients (lpc.c:156-263), batched.

    lp_coeff [..., max_order] float32; order / precision [...] int32.
    Returns (qlp [..., max_order] int32, shift [...] int32, ok [...] bool),
    with the reference's error feedback, the shift clamp to [.., 15] and
    the negative-shift fallback that reports shift 0.
    """
    c = lp_coeff.to(torch.float64)
    dev = c.device
    L = max_order
    jrange = torch.arange(L, device=dev)
    active = jrange < order[..., None]
    p = precision - 1  # drop sign bit (lpc.c:166)
    one = torch.ones((), dtype=p.dtype, device=dev)
    qmax = (one << p) - 1
    qmin = -(one << p)
    cmax = torch.where(active, c.abs(), 0.0).amax(dim=-1)
    ok_nonzero = cmax > 0.0  # all-zero coeffs: "constant-detect didn't work"
    e = bitmath.frexp_exponent(torch.where(ok_nonzero, cmax, 1.0))
    log2cmax = e - 1
    shift = p - log2cmax - 1
    max_shiftlimit = (1 << 4) - 1  # (1<<(QLP_SHIFT_LEN-1))-1 = 15
    min_shiftlimit = -max_shiftlimit - 1
    ok_shift = shift >= min_shiftlimit  # too-small shift: ret 1
    shift = torch.clamp(shift, max=max_shiftlimit)
    # 2^shift, exact also for negative shift, from int64 shifts like
    # flac_tpu (lanes with |shift| > 62 are masked off by ok_shift / clamp)
    shift_c = torch.clamp(shift, -62, 62).to(torch.int64)
    one64 = torch.ones((), dtype=torch.int64, device=dev)
    scale = (torch.where(shift_c >= 0, one64 << shift_c.clamp(min=0), 1)
             .to(torch.float64)
             / torch.where(shift_c < 0, one64 << (-shift_c).clamp(min=0), 1)
             .to(torch.float64))
    err = torch.zeros(c.shape[:-1], dtype=torch.float64, device=dev)
    qmin_f, qmax_f = qmin.to(torch.float64), qmax.to(torch.float64)
    qs = []
    for j in range(L):
        err_new = err + c[..., j] * scale
        q = torch.where(err_new >= 0.0, torch.floor(err_new + 0.5),
                        torch.ceil(err_new - 0.5))
        q = torch.minimum(torch.maximum(q, qmin_f), qmax_f)
        is_act = active[..., j]
        qs.append(torch.where(is_act, q, 0.0).to(torch.int32))
        err = torch.where(is_act, err_new - q, err)
    qlp = torch.stack(qs, dim=-1)
    shift_out = torch.clamp(shift, min=0)  # negative shift: decoder NOP -> 0
    return qlp, shift_out.to(torch.int32), ok_nonzero & ok_shift


def lpc_residual(x: torch.Tensor, qlp: torch.Tensor, order: torch.Tensor,
                 shift: torch.Tensor, max_order: int,
                 narrow: bool = False) -> torch.Tensor:
    """residual[t] = x[t] - (sum_{j=1..order} qlp[j-1] * x[t-j] >> shift).

    x: [..., T] int32; qlp: [..., max_order]; order/shift: [...]. Entries
    t < order are zeroed. narrow=True keeps the accumulator in int32, exact
    whenever bps + qlp precision + ilog2(order) <= 32 (stream_encoder.c:3592;
    the caller checks this statically); otherwise int64.
    """
    T = x.shape[-1]
    dt = torch.int32 if narrow else torch.int64
    xw = x.to(dt)
    acc = torch.zeros_like(xw)
    for j in range(1, max_order + 1):
        coef = qlp[..., j - 1].to(dt)
        lag = torch.roll(xw, j, dims=-1)  # x[t-j]; wrapped t<order masked below
        acc = acc + torch.where((j <= order)[..., None], coef[..., None] * lag, 0)
    pred = acc >> shift[..., None].to(dt)
    t = torch.arange(T, device=x.device)
    res = torch.where(t >= order[..., None], xw - pred, 0)
    return res.to(torch.int32)


def lpc_residual_limbs(x: torch.Tensor, qlp: torch.Tensor, order: torch.Tensor,
                       shift: torch.Tensor, max_order: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wide-datapath residual from two int32 limbs, flac_tpu's
    `lpc_residual_limbs` (lpc.c:531 is the reference's _wide path).

    x = (x >> 12) * 2^12 + (x & 0xFFF); the two partial dot products are
    summed in int32 (wrapping as int32 does):

        acc = A_hi*2^12 + A_lo,  H = A_hi + (A_lo>>12),  r = A_lo & 0xFFF
        acc>>s = H >> (s-12)                    for s >= 12
               = (H << (12-s)) + (r >> s)       for s <  12

    The caller gates on the static bound that keeps the limb sums in int32
    (effective bps <= 25, precision <= 15, order <= 16). Returns (res [...,
    T] int32, ovf [...] bool): `ovf` marks candidates whose s < 12
    prediction left int32 (|H| >= 2^min(19+s, 30) at a valid sample); the
    encoder masks them out, so it must be flac_tpu's exactly.
    """
    T = x.shape[-1]
    x = x.to(torch.int32)
    xl = x & 0xFFF
    xh = x >> 12
    shape = torch.broadcast_shapes(x.shape, qlp.shape[:-1] + (T,))
    acc_lo = torch.zeros(shape, dtype=torch.int32, device=x.device)
    acc_hi = torch.zeros_like(acc_lo)
    for j in range(1, max_order + 1):
        coef = qlp[..., j - 1].to(torch.int32)[..., None]
        active = (j <= order)[..., None]
        acc_lo = acc_lo + torch.where(active, coef * torch.roll(xl, j, dims=-1), 0)
        acc_hi = acc_hi + torch.where(active, coef * torch.roll(xh, j, dims=-1), 0)
    H = acc_hi + (acc_lo >> 12)
    r = acc_lo & 0xFFF  # >= 0: its right shift is a logical one
    s = shift[..., None].to(torch.int32)
    pred_ge = H >> torch.clamp(s - 12, min=0)
    pred_lt = (H << torch.clamp(12 - s, min=0)) + (r >> torch.clamp(s, max=12))
    pred = torch.where(s >= 12, pred_ge, pred_lt)
    valid = torch.arange(T, device=x.device) >= order[..., None]
    res = torch.where(valid, x - pred, 0)
    lim = torch.ones_like(s) << torch.clamp(19 + s, max=30)
    ovf = ((s < 12) & (H.abs() >= lim) & valid).any(dim=-1)
    return res, ovf


def lpc_restore_plain(residual: torch.Tensor, qlp: torch.Tensor,
                      order: torch.Tensor, shift: torch.Tensor,
                      warmup: torch.Tensor, max_order: int) -> torch.Tensor:
    """The plain PyTorch lpc_restore, flac_tpu's scan as a loop over time
    with the whole batch in each step: the history is int64 (newest at
    column 0), the prediction's shift arithmetic, the result cast to int32."""
    B, T = residual.shape
    dev = residual.device
    res64 = residual.to(torch.int64)
    hist = torch.zeros((B, max_order), dtype=torch.int64, device=dev)  # x[t-1-j]
    qlp64 = torch.where(torch.arange(max_order, device=dev)[None, :] < order[:, None],
                        qlp.to(torch.int64), 0)
    shift64 = shift.to(torch.int64)
    w = warmup.to(torch.int64)
    out = torch.empty((B, T), dtype=torch.int64, device=dev)
    for t in range(T):
        pred = (qlp64 * hist).sum(dim=1) >> shift64
        w_t = w[:, t] if t < max_order else 0
        x_t = torch.where(t < order, w_t, res64[:, t] + pred)
        hist = torch.cat([x_t[:, None], hist[:, :-1]], dim=1)
        out[:, t] = x_t
    return out.to(torch.int32)


def lpc_restore(residual: torch.Tensor, qlp: torch.Tensor, order: torch.Tensor,
                shift: torch.Tensor, warmup: torch.Tensor, max_order: int
                ) -> torch.Tensor:
    """Decode-side FLAC__lpc_restore_signal[_wide] (lpc.c:795,1061),
    batched: for t < order x[t] = warmup[t], then x[t] = residual[t] +
    ((sum_{j < order} qlp[j] * x[t-1-j]) >> shift), in int64.

    residual [B, T] int32 (entries t < order ignored); qlp, warmup [B,
    max_order] (the first `order` used); order, shift [B], shift in [0, 63].
    Returns [B, T] int32. CUDA tensors run the frame decoder's restore
    kernel (one launch, every row coded; max_order <= 32, FLAC's largest
    order); CPU tensors take lpc_restore_plain."""
    if residual.device.type == "cpu":
        return lpc_restore_plain(residual, qlp, order, shift, warmup, max_order)
    if not 0 <= max_order <= 32:
        raise ValueError(f"lpc_restore: max_order {max_order} is outside [0, 32]")
    B, T = residual.shape

    def rows(t):
        return t.to(torch.int64).reshape(B, max_order)

    x = _restore_scan.restore_scan(
        residual.to(torch.int32), rows(qlp), order.to(torch.int64),
        shift.to(torch.int64), rows(warmup),
        torch.ones(B, dtype=torch.bool, device=residual.device), T, max_order)
    return x.to(torch.int32)
