"""The bytes that ReplayGain's equal-loudness filter has to move, whatever
its implementation: each sample of each channel read once at the stream's
width, and one float64 a 50 ms window a channel written (its sum of
squares), worked out from the call's own audio."""

from __future__ import annotations


def filter_bytes(samples: int, windows: int, channels: int, sample_bytes: int) -> int:
    return samples * channels * sample_bytes + 8 * windows * channels
