"""Short clips cut from a pool: every length of the mix's set once a
cycle, in an order drawn from the seed, each at an offset drawn from the
seed (traffic.clip_cycle)."""

from __future__ import annotations

from types import SimpleNamespace

from cardbench import traffic


def make(torch, conf, mix: dict, seed: int, device):
    rate = conf.sample_rate
    sections = [int(s * rate) for s in mix["pool_sections_seconds"]]
    pcm = traffic.to_host(traffic.music(sections, rate, conf.bits, seed, "clips", device))
    lengths = traffic.stratified(int(mix["clip_seconds"][0] * rate),
                                 int(mix["clip_seconds"][1] * rate), mix["clip_lengths"])

    def files():
        cycle = 0
        while True:
            for start, n in traffic.clip_cycle(lengths, len(pcm),
                                               traffic.rng(seed, "clip_cuts", cycle)):
                yield pcm, start, n
            cycle += 1

    return SimpleNamespace(pcm=pcm, files=files(), per_pass=len(lengths))
