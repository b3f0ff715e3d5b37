"""The benchmark's inputs, all made from `--seed`: music-like PCM on the
device, the cut of an album into tracks, and short clips.

The signal follows two generators of this repository, rewritten here to
make PCM on the device from the seed: `bench_torch.py`'s `make_corpus`
(tonal partials at 220, 659.3 and 1760 Hz under a slow amplitude
modulation, a noise floor, the right channel a scaled copy of the left)
and `chip_smoke.py`'s `burst_pcm` (full-scale noise bursts in a quiet
signal). Each section of an album draws its own transposition, modulation,
stereo image, noise floor and noise correlation between the channels, and
begins and ends in digital silence with a fade, so that constant, verbatim,
fixed and LPC subframes and every stereo decorrelation occur. Bursts rise
and fall over 1,024 samples, as a cymbal does, rather than in one sample.

Sizes never depend on the seed: an album's total length, a cut's number of
tracks and their bounds, and the set of clip lengths are fixed by the
configuration and the mix; the seed only orders them and fills them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# one stream of the seed for each purpose, so that the warm-up input never
# shares its random numbers with the timed files
STREAMS = {"album": 1, "cuts": 2, "warmup": 3, "clips": 4, "check": 5, "clip_cuts": 6}


def rng(seed: int, stream: str, *more: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, STREAMS[stream], *more]))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as host numpy, copied once."""
    host = torch.empty(t.shape, dtype=t.dtype)
    host.copy_(t)
    return host.numpy()


def _torch_seed(r: np.random.Generator) -> int:
    return int(r.integers(0, 2 ** 63 - 1))


def track_lengths(r: np.random.Generator, tracks: int, total: int, lo: int, hi: int) -> np.ndarray:
    """`tracks` lengths in [lo, hi] that sum to `total` exactly."""
    if not tracks * lo <= total <= tracks * hi:
        raise ValueError(f"{tracks} tracks of {lo}-{hi} cannot sum to {total}")
    for _ in range(10_000):
        x = lo + r.dirichlet(np.full(tracks, 4.0)) * (total - tracks * lo)
        if x.max() <= hi:
            break
    else:  # pragma: no cover - the draw above nearly always fits at once
        raise RuntimeError("no cut of the album fits the track bounds")
    n = np.floor(x).astype(np.int64)
    for i in np.argsort(n)[: total - int(n.sum())]:
        n[i] += 1
    return n


# each section's character: (low, high) of each drawn parameter
STYLE = {"transpose": (0.7, 1.4), "am_hz": (0.2, 0.6), "pan": (0.55, 1.0),
         "corr": (0.0, 0.95), "sigma": (0.0036, 0.0044), "lead_s": (0.3, 1.5),
         "tail_s": (0.3, 1.5), "fade_in_s": (0.5, 1.5), "fade_out_s": (0.5, 1.5)}


def styles(r: np.random.Generator, count: int) -> list[dict]:
    """The parameters of `count` sections: each parameter takes the same
    `count` values, evenly spread over its range, for every seed, dealt to
    the sections in an order drawn from r. So seeds differ in the order and
    the noise, not in how much the sections compress."""
    grid = (np.arange(count) + 0.5) / count
    dealt = {k: lo + (hi - lo) * grid[r.permutation(count)] for k, (lo, hi) in STYLE.items()}
    return [{k: float(v[i]) for k, v in dealt.items()} for i in range(count)]


def spread_lengths(r: np.random.Generator, tracks: int, total: int, lo: int,
                   hi: int) -> np.ndarray:
    """`tracks` lengths that sum to `total`, evenly spaced around their mean
    as far as [lo, hi] allows: the same set for every seed, in an order
    drawn from r."""
    mean = total / tracks
    step = 2 * min(mean - lo, hi - mean) / max(tracks - 1, 1)
    n = np.floor(mean + (np.arange(tracks) - (tracks - 1) / 2) * step).astype(np.int64)
    n[-1] += total - int(n.sum())
    return n[r.permutation(tracks)]


def music(lengths, rate: int, bits: int, seed: int, stream: str,
          device: torch.device) -> torch.Tensor:
    """int32 [sum(lengths), 2] PCM on `device`: one section a length."""
    device = torch.device(device)
    full = (1 << (bits - 1)) - 1
    out = torch.empty((int(sum(lengths)), 2), dtype=torch.int32, device=device)
    at = 0
    for s, (n, style) in enumerate(zip((int(v) for v in lengths),
                                       styles(rng(seed, stream), len(lengths)))):
        out[at:at + n] = _section(n, rate, full, style, rng(seed, stream, s), device)
        at += n
    return out


def _ramp(n: int, length: int, device) -> torch.Tensor:
    """A raised cosine from 0 to 1 over `length` samples, then 1, n long."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return torch.where(i < length, 0.5 - 0.5 * torch.cos(math.pi * i / max(length, 1)), 1.0)


def _section(n: int, rate: int, full: int, style: dict, r: np.random.Generator,
             device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(_torch_seed(r))
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    base = torch.zeros(n, dtype=torch.float64, device=device)
    for f, a, phase in zip((220.0, 659.3, 1760.0), (0.45, 0.25, 0.12),
                           r.uniform(0, 2 * math.pi, 3)):
        base += a * torch.sin(2 * math.pi * f * style["transpose"] * t + phase)
    base *= 0.6 + 0.4 * torch.sin(2 * math.pi * style["am_hz"] * t + r.uniform(0, 2 * math.pi))
    del t
    corr = style["corr"]
    noise = torch.randn((2, n), generator=g, dtype=torch.float32, device=device).double()
    noise[1] = corr * noise[0] + math.sqrt(1 - corr * corr) * noise[1]
    x = torch.stack([base + style["sigma"] * noise[0],
                     style["pan"] * base + style["sigma"] * noise[1]])
    del base, noise
    # digital silence at both ends, faded in and out
    lead, tail, fade_in, fade_out = (int(style[k] * rate) for k in
                                     ("lead_s", "tail_s", "fade_in_s", "fade_out_s"))
    lead, tail = min(lead, n // 4), min(tail, n // 4)
    env = torch.zeros(n, dtype=torch.float64, device=device)
    body = n - lead - tail
    if body > 0:
        env[lead:lead + body] = _ramp(body, min(fade_in, body // 2), device) \
            * torch.flip(_ramp(body, min(fade_out, body // 2), device), [0])
    x *= env
    # noise bursts at nearly full scale, one in about 45 s, each rising and
    # falling over 1,024 samples
    for _ in range(max(1, round(n / rate / 45))):
        length = int(r.uniform(0.15, 0.4) * rate)
        if length + 2048 >= body:
            break
        start = lead + int(r.integers(0, body - length))
        burst = torch.rand((2, length), generator=g, dtype=torch.float32, device=device)
        shape = _ramp(length, 1024, device) * torch.flip(_ramp(length, 1024, device), [0])
        x[:, start:start + length] += 0.95 * (2 * burst.double() - 1) * shape
    pcm = torch.clamp(torch.round(x * (0.855 * full)), -full - 1, full)
    return pcm.T.to(torch.int32)


def stratified(lo: int, hi: int, count: int) -> np.ndarray:
    """`count` lengths spread evenly over [lo, hi]."""
    return np.round(np.linspace(lo, hi, count)).astype(np.int64)


def clip_cycle(lengths: np.ndarray, pool: int, r: np.random.Generator):
    """One cycle of clips: every length once, (start, length) each. The
    lengths come in pairs, the i-th shortest with the i-th longest, in an
    order drawn from r, so that any run of clips holds about the cycle's
    mean length; the starts are spread over the pool, one a stratum, the
    strata in an order drawn from r."""
    order = np.sort(lengths)
    k = len(order)
    pairs = [(order[i], order[k - 1 - i]) for i in range(k // 2)]
    if k % 2:
        pairs.append((order[k // 2],))
    seq = [int(n) for p in r.permutation(len(pairs))
           for n in (pairs[p] if r.random() < 0.5 else pairs[p][::-1])]
    strata = r.permutation(k)
    return [(int((strata[i] + r.random()) / k * (pool - n)), n) for i, n in enumerate(seq)]
