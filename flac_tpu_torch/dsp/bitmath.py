"""Integer bit-math helpers (the port of flac_tpu.dsp.bitmath, the analog of
src/libFLAC/bitmath.c)."""

from __future__ import annotations

import torch


def bitlen64(x: torch.Tensor) -> torch.Tensor:
    """Number of bits needed for x >= 0 (0 -> 0), exact, integer-only.
    int32 inputs stay int32; returns int32."""
    if x.dtype == torch.int32:
        shifts = (16, 8, 4, 2, 1)
    else:
        x = x.to(torch.int64)
        shifts = (32, 16, 8, 4, 2, 1)
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in shifts:
        m = x >> s
        c = m > 0
        n = n + torch.where(c, s, 0).to(torch.int32)
        x = torch.where(c, m, x)
    return n + (x > 0).to(torch.int32)


def tree_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce the last axis with a bitwise OR or XOR (`op`), which torch has
    no reduction for: a pairwise tree, zero-padded (0 is the identity of
    both) to an even length at each level. Exact in any order."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        x = op(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x >= 1 (FLAC__bitmath_ilog2, bitmath.c:61)."""
    return bitlen64(x) - 1


def frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    """The frexp exponent e of x > 0 (x = m * 2^e with 0.5 <= m < 1), read
    from the float32 bit pattern exactly as flac_tpu does (so values within
    one f32 ulp of a power of two round the same way in both packages)."""
    bits = x.to(torch.float32).view(torch.int32)
    raw_exp = (bits >> 23) & 0xFF
    return (raw_exp - 126).to(torch.int32)
