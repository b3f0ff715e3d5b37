"""An album cut into tracks, played track after track, pass after pass.

The album's length is scaled to the tracks the mix or configuration keeps,
its sections are the first pass's tracks. A mix with "lengths": "spread"
cuts every pass into the same set of lengths (traffic.spread_lengths);
others draw each pass anew (traffic.track_lengths), so that every track
ends in a partial frame of a fresh length."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from cardbench import traffic


def pool(torch, conf, mix: dict, seed: int, device):
    """(host PCM of the album's kept tracks, cut(pass) -> its lengths)."""
    kept = min(conf.tracks, mix.get("tracks", conf.tracks))
    total = int(round(conf.album_seconds * conf.sample_rate * kept / conf.album_tracks))
    lo, hi = (int(s * conf.sample_rate) for s in conf.track_seconds)
    draw = traffic.spread_lengths if mix.get("lengths") == "spread" else traffic.track_lengths

    def cut(p: int) -> np.ndarray:
        return draw(traffic.rng(seed, "cuts", p), kept, total, lo, hi)

    pcm = traffic.to_host(traffic.music(cut(0), conf.sample_rate, conf.bits, seed, "album",
                                        device))
    return pcm, cut


def tracks(pcm, cut):
    """Tracks in turn, pass after pass, each pass cut by cut(pass)."""
    p = 0
    while True:
        lengths = cut(p)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        for s, n in zip(starts, lengths):
            yield pcm, int(s), int(n)
        p += 1


def make(torch, conf, mix: dict, seed: int, device):
    pcm, cut = pool(torch, conf, mix, seed, device)
    return SimpleNamespace(pcm=pcm, files=tracks(pcm, cut), per_pass=len(cut(0)))
