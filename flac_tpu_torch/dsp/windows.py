"""Apodization windows.

The 15 window generators of the reference (src/libFLAC/window.c:49-223),
evaluated once per (spec, blocksize) on the host in float64 and cast to
float32 (the reference's FLAC__real). Window specs are parsed from the same
"name(arg)" strings the encoder's apodization option accepts
(stream_encoder.c:1526-1595), default "tukey(0.5)".
"""

from __future__ import annotations

import functools

import numpy as np

WINDOW_NAMES = (
    "bartlett", "bartlett_hann", "blackman", "blackman_harris_4term_92db",
    "connes", "flattop", "gauss", "hamming", "hann", "kaiser_bessel",
    "nuttall", "rectangle", "triangle", "tukey", "welch",
)


def _bartlett(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    if L & 1:
        return np.where(n <= N / 2, 2.0 * n / N, 2.0 - 2.0 * n / N)
    return np.where(n <= L / 2 - 1, 2.0 * n / N, 2.0 - 2.0 * (N - n) / N)


def _bartlett_hann(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return 0.62 - 0.48 * np.abs(n / N + 0.5) + 0.38 * np.cos(2 * np.pi * (n / N + 0.5))


def _blackman(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return 0.42 - 0.5 * np.cos(2 * np.pi * n / N) + 0.08 * np.cos(4 * np.pi * n / N)


def _blackman_harris_4term_92db(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.35875 - 0.48829 * np.cos(2 * np.pi * n / N)
            + 0.14128 * np.cos(4 * np.pi * n / N) - 0.01168 * np.cos(6 * np.pi * n / N))


def _connes(L: int) -> np.ndarray:
    N = L - 1
    N2 = N / 2.0
    k = (np.arange(L, dtype=np.float64) - N2) / N2
    return (1.0 - k * k) ** 2


def _flattop(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (1.0 - 1.93 * np.cos(2 * np.pi * n / N) + 1.29 * np.cos(4 * np.pi * n / N)
            - 0.388 * np.cos(6 * np.pi * n / N) + 0.0322 * np.cos(8 * np.pi * n / N))


def _gauss(L: int, stddev: float) -> np.ndarray:
    N = L - 1
    N2 = N / 2.0
    k = (np.arange(L, dtype=np.float64) - N2) / (stddev * N2)
    return np.exp(-0.5 * k * k)


def _hamming(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2 * np.pi * n / N)


def _hann(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2 * np.pi * n / N)


def _kaiser_bessel(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.402 - 0.498 * np.cos(2 * np.pi * n / N) + 0.098 * np.cos(4 * np.pi * n / N)
            - 0.001 * np.cos(6 * np.pi * n / N))


def _nuttall(L: int) -> np.ndarray:
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.3635819 - 0.4891775 * np.cos(2 * np.pi * n / N)
            + 0.1365995 * np.cos(4 * np.pi * n / N) - 0.0106411 * np.cos(6 * np.pi * n / N))


def _rectangle(L: int) -> np.ndarray:
    return np.ones(L, dtype=np.float64)


def _triangle(L: int) -> np.ndarray:
    # note: mirrors the reference's triangle including its odd-L quirk
    # (window.c:193-207, the second loop's negated form)
    out = np.empty(L, dtype=np.float64)
    if L & 1:
        for n in range(1, L + 1):
            if n <= (L + 1) // 2:
                out[n - 1] = 2.0 * n / (L + 1.0)
            else:
                out[n - 1] = -(2.0 * (L - n + 1)) / (L + 1.0)
    else:
        for n in range(1, L + 1):
            if n <= L // 2:
                out[n - 1] = 2.0 * n / L
            else:
                out[n - 1] = (2.0 * (L - n) + 1.0) / L
    return out


def _tukey(L: int, p: float) -> np.ndarray:
    if p <= 0:
        return _rectangle(L)
    if p >= 1:
        return _hann(L)
    Np = int(p / 2.0 * L) - 1
    out = _rectangle(L)
    if Np > 0:
        n = np.arange(Np + 1, dtype=np.float64)
        out[: Np + 1] = 0.5 - 0.5 * np.cos(np.pi * n / Np)
        out[L - Np - 1 :] = 0.5 - 0.5 * np.cos(np.pi * (n + Np) / Np)
    return out


def _welch(L: int) -> np.ndarray:
    N = L - 1
    N2 = N / 2.0
    k = (np.arange(L, dtype=np.float64) - N2) / N2
    return 1.0 - k * k


def parse_apodization_spec(spec: str) -> tuple[tuple[str, float | None], ...]:
    """Parse "tukey(0.5);hann;..." into ((name, arg), ...) — max 32 windows,
    unknown names skipped, empty result falls back to tukey(0.5)
    (stream_encoder.c:1526-1595)."""
    out: list[tuple[str, float | None]] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "(" in part:
            name, argstr = part.split("(", 1)
            name = name.strip()
            try:
                arg: float | None = float(argstr.rstrip(") "))
            except ValueError:
                continue
        else:
            name, arg = part, None
        if name in ("gauss", "tukey"):
            if arg is None:
                continue
            if name == "gauss" and not (0.0 < arg <= 0.5):
                continue
        elif name not in WINDOW_NAMES:
            continue
        else:
            arg = None
        out.append((name, arg))
        if len(out) == 32:
            break
    if not out:
        out = [("tukey", 0.5)]
    return tuple(out)


@functools.lru_cache(maxsize=256)
def make_window(name: str, blocksize: int, arg: float | None = None) -> np.ndarray:
    """float32 window of length `blocksize`."""
    fns = {
        "bartlett": _bartlett, "bartlett_hann": _bartlett_hann, "blackman": _blackman,
        "blackman_harris_4term_92db": _blackman_harris_4term_92db, "connes": _connes,
        "flattop": _flattop, "hamming": _hamming, "hann": _hann,
        "kaiser_bessel": _kaiser_bessel, "nuttall": _nuttall, "rectangle": _rectangle,
        "triangle": _triangle, "welch": _welch,
    }
    if name == "gauss":
        w = _gauss(blocksize, arg)
    elif name == "tukey":
        w = _tukey(blocksize, arg)
    else:
        w = fns[name](blocksize)
    return w.astype(np.float32)


def make_window_bank(specs: tuple[tuple[str, float | None], ...], blocksize: int) -> np.ndarray:
    """[num_windows, blocksize] float32 stack for the encoder's window sweep."""
    return np.stack([make_window(name, blocksize, arg) for name, arg in specs])
