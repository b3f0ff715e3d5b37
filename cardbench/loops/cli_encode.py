"""The `flac` command loop: the source's first pass written as WAVE files,
then one in-process call of the program's command
(`flac_tpu_torch.cli.flac.main`) a unit over all of them, as a user's
shell runs `flac -<level> <mix's flags> *.wav`: every file encoded to a
FLAC file beside its WAVE file and, with --replay-gain, the album's
ReplayGain computed and stored in each file's tags. The files live in a
directory of their own under the process's temporary directory (TMPDIR),
removed after the check.

The check decodes the kept calls' files with the plain reference, as the
encode loop's, and holds each file's ReplayGain tags against the plain
ReplayGain reference (reference/replaygain.py) over the seeded PCM: a gain
that is not the reference's (GAIN_TOLERANCE_DB there), or any other tag
that is not the same string, counts in `streaminfo_wrong`; a call that
returned non-zero counts in `files_failed`."""

from __future__ import annotations

import atexit
import json
import os
import shutil
import struct
import sys
import tempfile

import numpy as np

from cardbench import check as checks
from cardbench import traffic
from cardbench.reference import replaygain as rgref


def write_wav(path: str, pcm: np.ndarray, rate: int, bits: int) -> None:
    """A canonical PCM WAVE file: the 44-byte header, then the samples."""
    if bits != 16:
        raise ValueError("the cli_encode loop writes 16-bit WAVE files only")
    n, ch = pcm.shape
    data = np.ascontiguousarray(pcm, "<i2")
    size = data.nbytes
    head = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + size, b"WAVE", b"fmt ", 16, 1,
                       ch, rate, rate * ch * 2, ch * 2, 16, b"data", size)
    with open(path, "wb") as f:
        f.write(head)
        data.tofile(f)


def _argv(run, wavs: list) -> list:
    c = run.conf
    return [f"-{c.level}", *(["-V"] if c.verify else []), *run.mix["flags"], *wavs]


def _write_album(run, directory: str, tracks, pcm) -> list:
    os.makedirs(directory)
    wavs = []
    for k, (start, n) in enumerate(tracks):
        part = pcm[start:start + n]
        path = os.path.join(directory, f"track{k + 1:02d}.wav")
        write_wav(path, part & ~1 if run.control == "lsb" else part, run.conf.sample_rate,
                  run.conf.bits)
        wavs.append(path)
    return wavs


def setup(run) -> None:
    """The WAVE files of the source's first pass (of the PCM with its lowest
    bit cleared, for the control), then one call over warm-up WAVE files
    from a stream of the seed of their own: three 64-frame batches and a
    partial frame, and one batch and a partial frame, so that the call
    captures the full-batch and tail steps, builds the decode and filter
    kernels and runs a whole tagging pass."""
    from flac_tpu_torch.cli import flac
    from flac_tpu_torch.device import resolve_device
    if resolve_device(os.environ.get("FLAC_TPU_DEVICE") or None).type != run.device.type:
        raise RuntimeError("FLAC_TPU_DEVICE sends the program to another device than the run's")
    root = tempfile.mkdtemp(prefix="cardbench-cli-")
    atexit.register(shutil.rmtree, root, True)
    tracks = [(start, n) for _, start, n in
              (next(run.source.files) for _ in range(run.source.per_pass))]
    c = run.conf
    bs = c.blocksize
    warm_n = [3 * 64 * bs + bs // 3, 64 * bs + bs // 2]
    warm = traffic.to_host(traffic.music(warm_n, c.sample_rate, c.bits, run.seed, "warmup",
                                         run.device))
    warm_wavs = _write_album(run, os.path.join(root, "warmup"),
                             [(0, warm_n[0]), (warm_n[0], warm_n[1])], warm)
    rc = flac.main(_argv(run, warm_wavs))
    if rc != 0:
        raise RuntimeError(f"the warm-up call returned {rc}")
    shutil.rmtree(os.path.join(root, "warmup"))
    wavs = _write_album(run, os.path.join(root, "album"), tracks, run.source.pcm)
    w = rgref.window_length(c.sample_rate)
    run.state.update(root=root, tracks=tracks, argv=_argv(run, wavs),
                     outs=[p[:-len(".wav")] + ".flac" for p in wavs],
                     windows_per_call=sum(n // w for _, n in tracks))


def _keep(run, call: int) -> str:
    """Move the outputs now at the album's paths into a directory of the
    call's own."""
    d = os.path.join(run.state["root"], f"kept{call}")
    os.makedirs(d)
    for p in run.state["outs"]:
        if os.path.exists(p):
            os.rename(p, os.path.join(d, os.path.basename(p)))
    return d


def drive(run, window) -> None:
    """One call a unit until the window closes. Keeps each call's return
    code in run.state["calls"], and in run.state["kept"] (call, directory)
    of the files for the check: one call drawn from the seed (a reservoir
    of one) and the last call, the one the close cut. A kept call's files
    are moved away, so the next call writes its files anew."""
    from flac_tpu_torch.cli import flac
    argv, outs = run.state["argv"], run.state["outs"]
    samples = sum(n for _, n in run.state["tracks"])
    rng = traffic.rng(run.seed, "check", 0)
    calls, drawn, dropped = [], None, []
    while window.open:
        i = len(calls)
        with window.unit("cli.call"):
            rc = flac.main(argv)
        calls.append(rc)
        ok = rc == 0
        window.add(samples=samples if ok else 0,
                   bytes=sum(os.path.getsize(p) for p in outs if os.path.exists(p)) if ok else 0)
        if window.open and int(rng.integers(0, i + 1)) == 0:
            if drawn is not None:
                dropped.append(drawn[1])
            drawn = (i, _keep(run, i))
    kept = [drawn] if drawn is not None else []
    kept.append((len(calls) - 1, _keep(run, len(calls) - 1)))
    for d in dropped:
        shutil.rmtree(d, ignore_errors=True)
    run.state["calls"], run.state["kept"] = calls, kept


def result(run, rec: dict) -> tuple[int, int]:
    # the encode cells' readers read an encode loop's record, which this is
    rec["loop"] = "encode"
    rec["replaygain_windows_per_call"] = run.state["windows_per_call"]
    calls = run.state["calls"]
    return len(calls), sum(rc != 0 for rc in calls)


def check(run) -> dict:
    """The encode check of each kept call's files (a file whose bytes equal
    those of a file already decoded for the same track is not decoded
    again: the same bytes decode alike), and every file's tags against the
    reference's. Logs the largest gain difference from the reference, in
    0.01 dB steps, to standard error."""
    c, pcm, tracks = run.conf, run.source.pcm, run.state["tracks"]
    want = rgref.tags(rgref.analyse([pcm[s:s + n] for s, n in tracks], c.bits, c.sample_rate,
                                    device=run.device))
    numbers = dict.fromkeys(checks.LIMITS, 0)
    numbers["files_checked"] = 0
    rng = traffic.rng(run.seed, "check", 1)
    decoded, steps = {}, 0.0  # decoded: track start -> the bytes decoded for it
    for _call, d in run.state.pop("kept"):
        files = []
        for (start, n), out in zip(tracks, run.state["outs"]):
            path = os.path.join(d, os.path.basename(out))
            data = open(path, "rb").read() if os.path.exists(path) else None
            files.append(dict(start=start, n=n, data=data,
                              error=None if data is not None else "no output file"))
        fresh = [f for f in files if f["data"] is None or decoded.get(f["start"]) != f["data"]]
        if fresh:
            for k, v in checks.check_encode(fresh, pcm, c, rng, run.device).items():
                numbers[k] += v
        numbers["files_checked"] += len(files) - len(fresh)
        for f, tags in zip(files, want):
            if f["data"] is None:
                continue
            decoded[f["start"]] = f["data"]
            got = rgref.replaygain_tags(f["data"])
            numbers["streaminfo_wrong"] += rgref.mismatches(got, tags)
            steps = max([steps] + [rgref.gain_steps(got[k], tags[k])
                                   for k in rgref.GAINS if k in got])
        shutil.rmtree(d, ignore_errors=True)
    numbers["files_failed"] += sum(rc != 0 for rc in run.state["calls"])
    shutil.rmtree(run.state["root"], ignore_errors=True)
    print(json.dumps({"replaygain_gain_steps_off": steps}), file=sys.stderr)
    return numbers
