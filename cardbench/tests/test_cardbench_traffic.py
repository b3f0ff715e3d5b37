"""The traffic generators on the CPU: the same seed gives the same PCM,
lengths and album total; another seed other PCM in the same sizes."""

from __future__ import annotations

import numpy as np
import pytest

from cardbench import harness, traffic
from cardbench.files import album
from cardbench.files import clips as clip_files


def test_same_seed_same_pcm_and_another_seed_other_pcm():
    big = 2 ** 31 + 977  # more than 32 signed bits hold
    a = traffic.music([3000, 5000], 44100, 16, big, "album", "cpu")
    b = traffic.music([3000, 5000], 44100, 16, big, "album", "cpu")
    c = traffic.music([3000, 5000], 44100, 16, big + 1, "album", "cpu")
    w = traffic.music([3000, 5000], 44100, 16, big, "warmup", "cpu")
    assert a.shape == (8000, 2) and a.dtype.is_floating_point is False
    assert np.array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    assert not np.array_equal(a.numpy(), w.numpy())  # the warm-up's stream is its own


@pytest.mark.parametrize("bits", [16, 24])
def test_music_fills_its_width_with_silence_at_the_ends(bits):
    x = traffic.music([44100 * 3], 44100, bits, 5, "album", "cpu").numpy()
    full = (1 << (bits - 1)) - 1
    assert x.min() >= -full - 1 and x.max() <= full
    assert np.all(x[:100] == 0) and np.all(x[-100:] == 0)  # digital silence
    assert np.abs(x).max() > full // 2  # a burst near full scale
    assert not np.array_equal(x[:, 0], x[:, 1])


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5, 2 ** 40])
def test_album_cuts_keep_their_total_and_bounds(seed):
    lo, hi, total = 150 * 44100, 480 * 44100, 4425 * 44100
    for p in range(3):
        n = traffic.track_lengths(traffic.rng(seed, "cuts", p), 14, total, lo, hi)
        assert len(n) == 14 and n.sum() == total == 195_142_500
        assert n.min() >= lo and n.max() <= hi
    again = traffic.track_lengths(traffic.rng(seed, "cuts", 0), 14, total, lo, hi)
    assert np.array_equal(again, traffic.track_lengths(traffic.rng(seed, "cuts", 0), 14,
                                                       total, lo, hi))
    four = traffic.track_lengths(traffic.rng(seed, "cuts", 0), 4, 55_755_000, lo, hi)
    assert four.sum() == 55_755_000


def test_album_files_pass_after_pass_cover_the_pool(tiny_root):
    import torch
    cell = harness.load_cell(tiny_root, "tiny_album_encode")
    conf = harness.Conf.read(cell.config)
    pcm, cut = album.pool(torch, conf, cell.mix, 9, "cpu")
    pcm2, _ = album.pool(torch, conf, cell.mix, 9, "cpu")
    total = round(1.2 * 44100)
    assert np.array_equal(pcm, pcm2) and len(pcm) == total
    files = album.tracks(pcm, cut)
    passes = [[next(files)[1:] for _ in range(3)] for _ in range(3)]
    for p in passes:
        assert sum(n for _, n in p) == total
        assert [s for s, _ in p] == list(np.cumsum([0] + [n for _, n in p[:-1]]))
    assert passes[0] != passes[1]  # each pass is cut anew


def test_a_spread_cut_is_one_set_of_lengths_for_every_seed(tiny_root):
    import torch
    cell = harness.load_cell(tiny_root, "tiny_album_decode")
    conf = harness.Conf.read(cell.config)
    cuts = [album.pool(torch, conf, dict(cell.mix, lengths="spread"), seed, "cpu")[1]
            for seed in (1, 2 ** 31 + 1)]
    assert sorted(cuts[0](0)) == sorted(cuts[1](0)) == sorted(cuts[0](5))
    assert sum(cuts[0](0)) == round(1.2 * 44100 * 2 / 3)
    n = traffic.spread_lengths(traffic.rng(3, "cuts", 0), 4, 55_755_000, 150 * 44100,
                               480 * 44100)
    assert n.sum() == 55_755_000 and n.min() >= 150 * 44100 and n.max() <= 480 * 44100


def test_clips_are_a_fixed_set_of_lengths_in_a_seeded_order(tiny_root):
    import torch
    cell = harness.load_cell(tiny_root, "tiny_clips_encode")
    conf = harness.Conf.read(cell.config)
    lengths = {}
    for seed in (3, 4):
        src = clip_files.make(torch, conf, cell.mix, seed, "cpu")
        pcm, files = src.pcm, src.files
        assert src.per_pass == 8
        clips = [next(files) for _ in range(8)]
        lengths[seed] = [n for _, _, n in clips]
        assert all(0 <= s and s + n <= len(pcm) for _, s, n in clips)
    assert sorted(lengths[3]) == sorted(lengths[4]) == list(
        traffic.stratified(int(0.05 * 44100), int(0.3 * 44100), 8))
    assert lengths[3] != lengths[4]
