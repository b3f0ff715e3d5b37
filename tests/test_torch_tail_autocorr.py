"""`dsp.lpc.autocorrelation_placed`, the autocorrelation of the
length-generic tail step (encode.frame_encoder.build_tail_encoder), on the
CPU: the one float32 reduction whose order follows the frame's length, so
every lag's products must sit where XLA:CPU's tree of 32-wide windows puts
them for that length. Held bit for bit against `autocorrelation` at the
length's own shape, the sign of zero included."""

from __future__ import annotations

import numpy as np
import torch

from flac_tpu_torch.dsp import lpc as t_lpc
from flac_tpu_torch.dsp import windows as t_windows


def _windowed(n: int, T: int, seed: int) -> np.ndarray:
    """A frame of n small integers (zeros, both signs, so that products of
    -0.0 occur) under a Tukey window, zero from n on, float32 [T]."""
    rng = np.random.default_rng(seed)
    x = np.zeros(T, np.float32)
    x[:n] = rng.integers(-3, 4, n).astype(np.float32) * t_windows.make_window("tukey", n, 0.5)
    return x


def test_placed_autocorrelation_is_bit_equal_at_every_length():
    """Every n in 33..4095 at maximum lag 8 (lags of 32 samples or fewer
    left out below n = 41), and a sample of n at lag 12, in one batched
    call each, against autocorrelation at the length's own shape; bit
    patterns compared, so a sign of zero counts."""
    T = 4096
    for maxlag, ns in ((8, range(33, T)), (12, range(45, T, 97))):
        ns = list(ns)
        w = torch.as_tensor(np.stack([_windowed(n, T, n) for n in ns]))
        got = t_lpc.autocorrelation_placed(w, maxlag, torch.as_tensor(ns))
        for i, n in enumerate(ns):
            lags = min(maxlag, n - 33)
            want = t_lpc.autocorrelation(w[i, :n], lags)
            assert torch.equal(got[i, : lags + 1].view(torch.int32), want.view(torch.int32)), n
