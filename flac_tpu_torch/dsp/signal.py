"""Per-frame signal utilities: wasted bits, constant detection, mid/side and
its decode-side undo (the port of flac_tpu.dsp.signal; get_wasted_bits_
stream_encoder.c:4108, the constant check :3218-3230, mid/side :1991-1992,
the stereo undo stream_decoder.c:2067-2103)."""

from __future__ import annotations

import torch

from flac_tpu_torch.dsp.bitmath import tree_reduce


def wasted_bits(x: torch.Tensor) -> torch.Tensor:
    """Shared trailing-zero-bit count of a frame's samples.

    x: [..., T] int32. Returns [...] int32 — 0 when the frame is all zeros.
    """
    acc = tree_reduce(x, torch.bitwise_or)
    # ctz via popcount((v & -v) - 1), in int32 wraparound like the reference
    low = acc & -acc
    ctz = _popcount32(low - 1)
    return torch.where(acc == 0, 0, ctz).to(torch.int32)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Popcount of int32 bit patterns (torch has no uint32 shifts: the
    uint32 arithmetic runs in int64 with explicit 32-bit masks)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def is_constant(x: torch.Tensor) -> torch.Tensor:
    """True where all samples in the frame equal the first sample."""
    return (x == x[..., :1]).all(dim=-1)


def mid_side(left: torch.Tensor, right: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """mid = (L+R)>>1 (arithmetic, NOT /2), side = L-R (stream_encoder.c:1991)."""
    return (left + right) >> 1, left - right


def undo_channel_assignment(ch0: torch.Tensor, ch1: torch.Tensor,
                            assignment: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoder-side stereo undo (stream_decoder.c:2067-2103): (left, right)
    of the two decoded subframe signals ch0, ch1 [..., T] under each
    frame's assignment [...] (0 independent, 1 left/side, 2 right/side, 3
    mid/side). Mid/side: L = ((mid << 1 | (side & 1)) + side) >> 1 and
    R = ((mid << 1 | (side & 1)) - side) >> 1."""
    a = assignment[..., None]
    mid2 = (ch0 << 1) | (ch1 & 1)
    left = torch.where(a == 1, ch0, torch.where(
        a == 2, ch0 + ch1, torch.where(a == 3, (mid2 + ch1) >> 1, ch0)))
    right = torch.where(a == 1, ch0 - ch1, torch.where(
        a == 2, ch1, torch.where(a == 3, (mid2 - ch1) >> 1, ch1)))
    return left, right
