"""The encode loop under flac -V: loops/encode.py's setup, drive, result
and check, with verify's guarantee held besides. The program's
`verified_frames` is read before and after the drive; each file finished
wrote ceil(n / blocksize) frames, and every frame written without having
been verified counts in `frame_errors`. A program that counts no verified
frame cannot hold the guarantee, and the run stops in set-up."""

from __future__ import annotations

from cardbench.loops import encode
from cardbench.metrics import _verify


def setup(run) -> None:
    if not run.conf.verify:
        raise RuntimeError("the encode_verify loop needs a configuration with verify")
    before = _verify.program.verified_frames
    encode.setup(run)
    if _verify.program.verified_frames == before:
        raise RuntimeError("the program verified no frame of the warm-up: it counts no "
                           "verified_frames, so the cell cannot hold verify's guarantee")


def drive(run, window) -> None:
    before = _verify.program.verified_frames
    encode.drive(run, window)
    run.state["verified"] = _verify.program.verified_frames - before


def result(run, rec: dict) -> tuple[int, int]:
    # the encode cells' readers read an encode loop's record, which this is
    rec["loop"] = "encode"
    return encode.result(run, rec)


def check(run) -> dict:
    bs = run.conf.blocksize
    written = sum(-(-f["n"] // bs) for f in run.state["files"] if f["data"] is not None)
    numbers = encode.check(run)
    numbers["frame_errors"] += max(written - run.state["verified"], 0)
    return numbers
