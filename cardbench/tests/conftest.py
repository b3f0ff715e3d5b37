"""Tiny cells for the CPU tests: a checkout of their own (tmp_path) holding
a copy of cardbench/ and a BENCHMARK.json that defines them, so that
nothing of the real benchmark is read or edited."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

# several test processes share the host: one thread each keeps them apart
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_CONFIGS = {
    "tiny_cd5": dict(sample_rate=44100, bits_per_sample=16, channels=2, level=5,
                     blocksize=1024, verify=False, album_seconds=1.2, album_tracks=3,
                     tracks=3, track_seconds=[0.3, 0.5]),
    "tiny_hires8": dict(sample_rate=96000, bits_per_sample=24, channels=2, level=8,
                        blocksize=1024, verify=False, album_seconds=0.6, album_tracks=3,
                        tracks=2, track_seconds=[0.15, 0.25]),
}
TINY_MIXES = {
    "tiny_album": dict(loop="encode", files="album"),
    "tiny_decode": dict(loop="decode", files="album", tracks=2, lengths="spread"),
    "tiny_clips": dict(loop="encode", files="clips", pool_sections_seconds=[2.0, 2.0],
                       clip_seconds=[0.05, 0.3], clip_lengths=8),
}
TINY_CELLS = [
    ("tiny_album_encode", "tiny_cd5", "tiny_album"),
    ("tiny_hires_encode", "tiny_hires8", "tiny_album"),
    ("tiny_album_decode", "tiny_cd5", "tiny_decode"),
    ("tiny_clips_encode", "tiny_cd5", "tiny_clips"),
]


def write_root(root: str, spec: dict | None = None) -> dict:
    """A checkout at `root`: cardbench/ copied, the tiny configurations and
    mixes added, and a BENCHMARK.json of the tiny cells with the real
    metrics (or `spec`)."""
    shutil.copytree(os.path.join(REPO, "cardbench"), os.path.join(root, "cardbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, conf in TINY_CONFIGS.items():
        with open(os.path.join(root, "cardbench", "configs", f"{name}.json"), "w") as f:
            json.dump(dict(conf, name=name), f)
    for name, mix in TINY_MIXES.items():
        with open(os.path.join(root, "cardbench", "mixes", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    if spec is None:
        with open(os.path.join(REPO, "BENCHMARK.json")) as f:
            real = json.load(f)
        cells = [c for c, _, _ in TINY_CELLS]
        spec = dict(real, configs=[
            dict(name=n, source="tiny", file=f"cardbench/configs/{n}.json", reduced=[], why="t")
            for n in TINY_CONFIGS],
            workloads=[dict(name=c, config=k, traffic=m, chips=1, why="t")
                       for c, k, m in TINY_CELLS])
        for group in ("end_to_end", "per_layer"):
            for m in spec[group]:
                if "workloads" in m:
                    m["workloads"] = [c for c in cells
                                      if _same_kind(c, m["workloads"])]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec


def _same_kind(tiny: str, real: list) -> bool:
    """The tiny cell stands for a real one of the metric's cells."""
    twin = {"tiny_album_encode": "cd5_album_encode",
            "tiny_hires_encode": "hires8_album_encode",
            "tiny_album_decode": "cd5_album_decode",
            "tiny_clips_encode": "cd5_clips_encode"}[tiny]
    return twin in real


@pytest.fixture
def tiny_root(tmp_path):
    write_root(str(tmp_path))
    return str(tmp_path)
