"""An album's kept tracks cut from PCM made of all the album's sections:
the configuration's `album_tracks` sections (traffic.music, one character
a section), together as long as the kept tracks, so that every seed deals
the whole album's characters into the tracks, as the whole album would,
and the tracks' compression moves little from seed to seed. The tracks
are cut as album.py cuts them: with "lengths": "spread" the same set of
lengths every pass. So each track is a medley of the sections it spans,
not one piece: this steadies the compression ratio from seed to seed.

Each section is played at a level of its own below full scale (GAIN_DB:
the same `album_tracks` levels for every seed, dealt in an order drawn from
the seed), so that the tracks' peaks differ and stay under full scale, while
the album as a whole holds the same levels for every seed."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from cardbench import traffic
from cardbench.files import album

GAIN_DB = (-6.0, -0.5)  # the range of the sections' levels
GAIN_STREAM = 101  # the levels' stream of the seed, apart from traffic.STREAMS'


def gains(seed: int, count: int) -> np.ndarray:
    """`count` linear gains, evenly spread in dB over GAIN_DB, in an order
    drawn from the seed."""
    r = np.random.default_rng(np.random.SeedSequence([seed, GAIN_STREAM]))
    lo, hi = GAIN_DB
    db = lo + (hi - lo) * (np.arange(count) + 0.5) / count
    return 10.0 ** (db[r.permutation(count)] / 20.0)


def make(torch, conf, mix: dict, seed: int, device):
    kept = min(conf.tracks, mix.get("tracks", conf.tracks))
    total = int(round(conf.album_seconds * conf.sample_rate * kept / conf.album_tracks))
    sections = np.full(conf.album_tracks, total // conf.album_tracks, np.int64)
    sections[:total % conf.album_tracks] += 1
    pcm = traffic.music(sections, conf.sample_rate, conf.bits, seed, "album", device)
    at = 0
    for n, g in zip(sections.tolist(), gains(seed, conf.album_tracks)):
        part = pcm[at:at + n]
        part.copy_(torch.round(part.double() * float(g)).to(torch.int32))
        at += n
    pcm = traffic.to_host(pcm)
    lo, hi = (int(s * conf.sample_rate) for s in conf.track_seconds)
    draw = traffic.spread_lengths if mix.get("lengths") == "spread" else traffic.track_lengths

    def cut(p: int) -> np.ndarray:
        return draw(traffic.rng(seed, "cuts", p), kept, total, lo, hi)

    return SimpleNamespace(pcm=pcm, files=album.tracks(pcm, cut), per_pass=kept)
