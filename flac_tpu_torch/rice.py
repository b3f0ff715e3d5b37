"""Partitioned-Rice parameter search, batched — the port of flac_tpu.rice
(stream_encoder.c:3666-4048): leaf sums, per-partition parameter estimate,
the reference's bit estimator, the descending partition-order sweep, and the
exact bit count of the chosen parameters.

Escape coding (do_escape, off in every preset) searches escaped (raw-bits)
partitions too (precompute_partition_info_escapes_, stream_encoder.c:3844;
set_partitioned_rice_, :4012-4021).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flac_tpu_torch import constants as C
from flac_tpu_torch.dsp.bitmath import bitlen64 as _bitlen


class RiceSearchResult(NamedTuple):
    approx_bits: torch.Tensor      # [...] int64 — the reference's estimator (selection)
    exact_bits: torch.Tensor       # [...] int64 — true residual-coding bits (layout)
    partition_order: torch.Tensor  # [...] int32
    params_leaf: torch.Tensor      # [..., 2^max_po] int32
    is_rice2: torch.Tensor         # [...] bool
    raw_bits_leaf: torch.Tensor    # [..., 2^max_po] int32; >0 where escaped


def _uint32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their uint32 values, held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def fold_residual(res: torch.Tensor, narrow: bool = False) -> torch.Tensor:
    """Sign-fold to unsigned: (v<<1)^(v>>31) (bitwriter.c:561).

    narrow=True stays in int32: the result is the reference's FLAC__uint32
    fold as an int32 bit pattern (wrapping exactly like it)."""
    if narrow:
        r = res.to(torch.int32)
        return (r << 1) ^ (r >> 31)
    r = res.to(torch.int64)
    return torch.where(r >= 0, r << 1, (-r << 1) - 1)


def rice_search(absres: torch.Tensor, folded: torch.Tensor, order: torch.Tensor,
                suggested: torch.Tensor, blocksize: int, min_po: int,
                max_po: int, rice_limit: int, do_escape: bool = False,
                compute_exact: bool = True, n: torch.Tensor | None = None
                ) -> RiceSearchResult:
    """Search partition orders [min_po, max_po] for the best Rice coding.

    absres: [..., T] |residual| (zeros at t < order), int32 or int64;
    folded: [..., T] sign-folded residuals (zeros at t < order); order and
    suggested (the estimator's parameter for partition order 0): [...].
    Descending order sweep with strict <, so ties keep the higher order
    (stream_encoder.c:3726). do_escape also weighs an escaped partition of
    raw residuals against each Rice partition; escape wins ties.

    n, a device tensor, is the length of a partial frame held in a buffer
    of `blocksize` samples (zeros from n on): one partition (max_po 0) of
    n samples.
    """
    T = blocksize
    batch = folded.shape[:-1]
    nleaf = 1 << max_po
    ps_leaf = T >> max_po
    leaf_sums = absres.reshape(batch + (nleaf, ps_leaf)).sum(
        dim=-1, dtype=torch.int64)
    sums_by_po = {max_po: leaf_sums}
    for po in range(max_po - 1, -1, -1):
        prev = sums_by_po[po + 1]
        sums_by_po[po] = prev[..., 0::2] + prev[..., 1::2]

    if do_escape:
        # a partition's raw width comes from rmax = OR(r >= 0 ? r : ~r) ==
        # OR(folded >> 1) (stream_encoder.c:3867-3880); the max has the same
        # bit length as the OR, and only the bit length is used
        fu = _uint32_bits(folded) if folded.dtype == torch.int32 else folded
        rmax_by_po = {max_po: (fu >> 1).reshape(batch + (nleaf, ps_leaf)).amax(dim=-1)}
        for po in range(max_po - 1, -1, -1):
            prev = rmax_by_po[po + 1]
            rmax_by_po[po] = torch.maximum(prev[..., 0::2], prev[..., 1::2])

    N = 1
    for d in batch:
        N *= d
    order_f = order.reshape(N)
    sugg_f = suggested.reshape(N)

    def pm(a):  # [..., nparts] -> [nparts, N] (partition-major)
        return a.reshape((N,) + a.shape[len(batch):]).movedim(0, -1)

    best_total = best_po = params_leaf = raw_leaf = None
    for po in range(max_po, min_po - 1, -1):
        nparts = 1 << po
        ps = T >> po
        sums = pm(sums_by_po[po])                         # [nparts, N]
        if n is None:
            n_p = torch.full((nparts, N), ps, dtype=torch.int64, device=sums.device)
            n_p[0] -= order_f.to(torch.int64)
        else:
            n_p = (n - order_f.to(torch.int64))[None, :]
        if po == 0:
            k = sugg_f[None, :].to(torch.int32)
        else:
            # smallest k with n*2^k >= sum  <=>  bitlen(ceil(sum/n) - 1)
            q = torch.div(sums + n_p - 1, torch.clamp(n_p, min=1),
                          rounding_mode="floor")
            k = torch.where(q <= 1, 0, _bitlen(q - 1))
            k = torch.clamp(k, max=rice_limit - 1)
        k64 = k.to(torch.int64)
        part_bits = (C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_PARAMETER_LEN
                     + (1 + k64) * n_p
                     + torch.where(k64 > 0, sums >> torch.clamp(k64 - 1, min=0),
                                   sums << 1)
                     - (n_p >> 1))
        if do_escape:
            # escape: a 5-bit RICE2 parameter, a 5-bit raw length and the
            # raw payload (stream_encoder.c:4012-4021); escape wins ties,
            # and the raw length must fit its 5 bits
            rmax = pm(rmax_by_po[po])
            rawb = torch.where(rmax > 0, _bitlen(rmax) + 1, 1).to(torch.int64)
            esc_bits = (C.ENTROPY_CODING_METHOD_PARTITIONED_RICE2_PARAMETER_LEN
                        + C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_RAW_LEN
                        + rawb * n_p)
            use_esc = (esc_bits <= part_bits) & (rawb <= 31)
            part_bits = torch.where(use_esc, esc_bits, part_bits)
            k = torch.where(use_esc, 0, k)  # an escaped partition stores 0
            raw_po = torch.where(use_esc, rawb, 0).to(torch.int32).repeat_interleave(
                nleaf // nparts, dim=0)
        total = (C.ENTROPY_CODING_METHOD_TYPE_LEN
                 + C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ORDER_LEN
                 + part_bits.sum(dim=0))                  # [N]
        # partition order invalid when a full partition is <= predictor order
        # (format.c:548; set_partitioned_rice_ returns false, :4010)
        invalid = (ps <= order_f) if po > 0 else (order_f >= (T if n is None else n))
        total = torch.where(invalid, 2 ** 62, total)
        k_po = k.repeat_interleave(nleaf // nparts, dim=0).to(torch.int32)
        if best_total is None:
            best_total, params_leaf = total, k_po
            best_po = torch.full(total.shape, po, dtype=torch.int32,
                                 device=total.device)
            if do_escape:
                raw_leaf = raw_po
        else:
            better = total < best_total
            best_total = torch.where(better, total, best_total)
            best_po = torch.where(better, po, best_po)
            params_leaf = torch.where(better[None, :], k_po, params_leaf)
            if do_escape:
                raw_leaf = torch.where(better[None, :], raw_po, raw_leaf)

    best_total = best_total.reshape(batch)
    best_po = best_po.reshape(batch)
    params_leaf = params_leaf.movedim(0, -1).reshape(batch + (nleaf,))
    raw_leaf = (raw_leaf.movedim(0, -1).reshape(batch + (nleaf,)) if do_escape
                else torch.zeros_like(params_leaf))
    is_rice2 = (params_leaf
                >= C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER
                ).any(dim=-1)
    if compute_exact:
        exact = rice_exact_bits(folded, params_leaf,
                                raw_leaf if do_escape else None, order,
                                best_po, blocksize, max_po, n=n)
    else:
        # the frame encoder computes exact bits after selection
        exact = torch.zeros_like(best_total)
    return RiceSearchResult(approx_bits=best_total, exact_bits=exact,
                            partition_order=best_po, params_leaf=params_leaf,
                            is_rice2=is_rice2, raw_bits_leaf=raw_leaf)


def rice_exact_bits(folded: torch.Tensor, params_leaf: torch.Tensor,
                    raw_leaf: torch.Tensor | None, order: torch.Tensor,
                    partition_order: torch.Tensor, blocksize: int,
                    max_po: int, n: torch.Tensor | None = None) -> torch.Tensor:
    """Exact emitted residual-coding bits for the given parameters: the sum
    over valid samples of (u >> k) + 1 + k (the raw width in an escaped
    partition, where raw_leaf > 0) plus the partition parameter fields and
    a 5-bit raw length per escaped partition. folded: [..., T] (int32 bit
    patterns, read as uint32 with uint32 wraparound, or int64); samples
    from n on do not count where a length n (a device tensor) is given.
    Returns [...] int64."""
    T = blocksize
    ps_leaf = T >> max_po
    narrow = folded.dtype == torch.int32
    fu = _uint32_bits(folded) if narrow else folded
    t = torch.arange(T, device=folded.device)
    k_samp = params_leaf.repeat_interleave(ps_leaf, dim=-1).to(torch.int64)
    valid = t >= order[..., None]
    if n is not None:
        valid = valid & (t < n)
    cw = (fu >> k_samp) + 1 + k_samp
    if narrow:
        cw = cw & 0xFFFFFFFF
    if raw_leaf is not None:
        raw_samp = raw_leaf.repeat_interleave(ps_leaf, dim=-1).to(torch.int64)
        cw = torch.where(raw_samp > 0, raw_samp, cw)
    cw_bits = torch.where(valid, cw, 0)
    is_rice2 = (params_leaf
                >= C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER
                ).any(dim=-1)
    plen = torch.where(is_rice2,
                       C.ENTROPY_CODING_METHOD_PARTITIONED_RICE2_PARAMETER_LEN,
                       C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_PARAMETER_LEN
                       ).to(torch.int64)
    one = torch.ones((), dtype=torch.int64, device=folded.device)
    nparts_chosen = one << partition_order.to(torch.int64)
    exact = (C.ENTROPY_CODING_METHOD_TYPE_LEN
             + C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ORDER_LEN
             + plen * nparts_chosen + cw_bits.sum(dim=-1, dtype=torch.int64))
    if raw_leaf is not None:
        # a 5-bit raw length per escaped partition; an escaped partition's
        # leaves all carry its raw width, so partitions = leaves >> (max_po - po)
        n_esc_leaves = (raw_leaf > 0).to(torch.int64).sum(dim=-1)
        n_esc = n_esc_leaves >> (max_po - partition_order).to(torch.int64)
        exact = exact + C.ENTROPY_CODING_METHOD_PARTITIONED_RICE_RAW_LEN * n_esc
    return exact
