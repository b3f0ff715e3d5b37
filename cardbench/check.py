"""The comparison that decides `correct`.

Encode cells: a sample of the window's files, drawn from the seed with the
longest among them, is decoded by the plain reference (reference/flac.py)
from the bytes the program wrote, and held against the seeded PCM: every
sample, every frame header's CRC-8 and every frame's CRC-16, and
STREAMINFO (total samples, geometry, frame sizes, MD5 of the PCM). A file
whose encode raised (verify's VerifyError) fails too.

Decode cells: the PCM that the program returned for a sample of its calls
is held against the seeded PCM of the stream's source, sample by sample;
a call that raised or reported an error fails.

Every number compared is exact: its limit is 0.
"""

from __future__ import annotations

import numpy as np

from cardbench.reference import flac as ref
from cardbench.reference.md5 import flac_md5

# at most this many frames a check: one block of the reference's lanes
CHECK_FRAMES = ref.LANES_PER_BLOCK

LIMITS = {"samples_wrong": 0, "frame_errors": 0, "streaminfo_wrong": 0, "files_failed": 0}


def pick(files: list, blocksize: int, rng: np.random.Generator) -> list:
    """The files to check: all of them if their frames fit CHECK_FRAMES,
    else the longest and then others in an order drawn from rng while they
    fit."""
    done = [f for f in files if f["data"] is not None]

    def frames(f):
        return -(-f["n"] // blocksize)

    if sum(frames(f) for f in done) <= CHECK_FRAMES:
        return done
    longest = max(done, key=lambda f: f["n"])
    out, total = [longest], frames(longest)
    for i in rng.permutation(len(done)):
        f = done[i]
        if f is not longest and total + frames(f) <= CHECK_FRAMES:
            out.append(f)
            total += frames(f)
    return out


def _mismatch(got: np.ndarray, want: np.ndarray) -> int:
    """Sample values that differ, a missing or extra value counting one."""
    n = min(len(got), len(want))
    extra = abs(len(got) - len(want)) * want.shape[1]
    if got.shape[1:] != want.shape[1:]:
        return want.size + got.size
    return int(np.count_nonzero(got[:n] != want[:n])) + extra


def check_encode(files: list, pcm: np.ndarray, conf, rng: np.random.Generator,
                 device) -> dict:
    """The numbers of an encode cell's check."""
    chosen = pick(files, conf.blocksize, rng)
    decoded = ref.decode_streams([f["data"] for f in chosen], device)
    n = dict.fromkeys(LIMITS, 0)
    n["files_failed"] = sum(f["error"] is not None for f in files)
    for f, d in zip(chosen, decoded):
        want = pcm[f["start"]:f["start"] + f["n"]]
        n["samples_wrong"] += _mismatch(d.pcm, want)
        n["frame_errors"] += len(d.errors)
        si = d.streaminfo
        sizes = d.frame_sizes
        expect = dict(sample_rate=conf.sample_rate, channels=conf.channels,
                      bits_per_sample=conf.bits, total_samples=f["n"],
                      min_blocksize=conf.blocksize, max_blocksize=conf.blocksize,
                      min_framesize=int(sizes.min()) if len(sizes) else 0,
                      max_framesize=int(sizes.max()) if len(sizes) else 0,
                      md5=flac_md5(want, conf.bits))
        n["streaminfo_wrong"] += sum(getattr(si, k) != v for k, v in expect.items())
    n["files_checked"] = len(chosen)
    return n


def check_decode(calls: list, kept: list, streams: list, pcm: np.ndarray) -> dict:
    """The numbers of a decode cell's check."""
    n = dict.fromkeys(LIMITS, 0)
    n["files_failed"] = sum(c["error"] is not None for c in calls)
    for i, got in kept:
        st = streams[calls[i]["stream"]]
        n["samples_wrong"] += _mismatch(got, pcm[st["start"]:st["start"] + st["n"]])
    n["files_checked"] = len(kept)
    return n


def verdict(numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and at least one file checked."""
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in LIMITS.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok and numbers["files_checked"] >= 1, checks
