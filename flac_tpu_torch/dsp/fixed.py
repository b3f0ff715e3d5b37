"""Fixed (polynomial) predictors, orders 0-4, batched over frames — the
port of flac_tpu.dsp.fixed (fixed.c:224-350 and :352, and the decode-side
restore of :395)."""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_FIXED_ORDER = 4

# binomial stencil rows: residual_o[t] = sum_j COEF[o][j] * x[t-j]
_STENCILS = np.array([
    [1, 0, 0, 0, 0],
    [1, -1, 0, 0, 0],
    [1, -2, 1, 0, 0],
    [1, -3, 3, -1, 0],
    [1, -4, 6, -4, 1],
], dtype=np.int32)

_LN2 = math.log(2.0)


def fixed_errors(x: torch.Tensor, wide: bool, n: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Total absolute error of each fixed order and the best-order choice
    (FLAC__fixed_compute_best_predictor, fixed.c:224): errors summed over
    data indices [MAX_FIXED_ORDER, T), or [MAX_FIXED_ORDER, n) where a
    length n (a device tensor) is given. In the narrow path the
    accumulators are uint32 and wrap (fixed.c:234), on purpose.

    x: [..., T] int32. Returns (total_errors [..., 5] int64, best_order
    [...] int32).
    """
    x64 = x.to(torch.int64)
    d0 = x64[..., 4:]
    d1 = torch.diff(x64, 1)[..., 3:]
    d2 = torch.diff(x64, 2)[..., 2:]
    d3 = torch.diff(x64, 3)[..., 1:]
    d4 = torch.diff(x64, 4)
    ds = (d0, d1, d2, d3, d4)
    if n is not None:
        keep = torch.arange(MAX_FIXED_ORDER, x.shape[-1], device=x.device) < n
        ds = [torch.where(keep, d, 0) for d in ds]
    errs = torch.stack([d.abs().sum(dim=-1) for d in ds], dim=-1)
    if not wide:
        errs = errs & 0xFFFFFFFF  # uint32 wraparound of the narrow accumulators
    # strict-< cascade (fixed.c:245-254): ties go to the higher order
    e0, e1, e2, e3, e4 = (errs[..., i] for i in range(5))
    mn = torch.minimum
    order = torch.where(
        e0 < mn(mn(e1, e2), mn(e3, e4)), 0,
        torch.where(e1 < mn(e2, mn(e3, e4)), 1,
                    torch.where(e2 < mn(e3, e4), 2,
                                torch.where(e3 < e4, 3, 4))))
    return errs, order.to(torch.int32)


def residual_bits_per_sample(total_errors: torch.Tensor,
                             n: int | torch.Tensor) -> torch.Tensor:
    """log2(ln2 * err / n) in float64, 0 when err == 0, returned as float32
    (fixed.c:266-270). n may be a device tensor."""
    e = total_errors.to(torch.float64)
    n = n.to(torch.float64) if isinstance(n, torch.Tensor) else float(n)
    bps = torch.log(_LN2 * e / n) / _LN2
    return torch.where(total_errors > 0, bps, 0.0).to(torch.float32)


def fixed_residuals_all_orders(x: torch.Tensor) -> torch.Tensor:
    """Residuals of every fixed order at once (fixed.c:352).

    x: [..., T] int32. Returns [..., 5, T] int32; entries t < o are zeroed.
    int32 throughout, as the reference computes them: mod-2^32 add/mul make
    stepwise int32 wraparound identical to int64-then-truncate.
    """
    T = x.shape[-1]
    x32 = x.to(torch.int32)
    t = torch.arange(T, device=x.device)
    outs = []
    for o in range(MAX_FIXED_ORDER + 1):
        acc = torch.zeros_like(x32)
        for j in range(o + 1):
            c = int(_STENCILS[o, j])
            # x[t-j]; the wrapped region t < o is masked below
            acc = acc + c * torch.roll(x32, j, dims=-1)
        outs.append(torch.where(t >= o, acc, 0))
    return torch.stack(outs, dim=-2)


def fixed_restore(residual: torch.Tensor, warmup: torch.Tensor, order: int
                  ) -> torch.Tensor:
    """Decode-side restore for a static order (FLAC__fixed_restore_signal,
    fixed.c:395), flac_tpu's form: the order-o residual is the o-th finite
    difference of the signal, so the restore is o nested int64 cumulative
    sums, each seeded by the matching difference of the warmup samples.

    residual [..., T - order] int32, warmup [..., order]. Returns [..., T]
    int32 (wrapping, as flac_tpu's cast does)."""
    if order == 0:
        return residual
    cur = warmup.to(torch.int64)
    seeds = []
    for _ in range(order):
        seeds.append(cur[..., 0:1])  # seed_k = (Delta^k x)[k]
        cur = cur[..., 1:] - cur[..., :-1]
    out = residual.to(torch.int64)  # (Delta^order x)[t] for t in [order, T)
    for k in range(order - 1, -1, -1):
        out = torch.cumsum(torch.cat([seeds[k], out], dim=-1), dim=-1,
                           dtype=torch.int64)
    return out.to(torch.int32)
