"""The encode loop: each file of the mix's source encoded into its own
in-memory stream by `StreamEncoder.process()` and `finish()`, as
`encode_file` runs it, one file after another. Units: each `process()`
chunk and each `finish()`. The check decodes the streams with the plain
reference."""

from __future__ import annotations

import io
import time

from cardbench import check as checks
from cardbench import traffic
from cardbench.loops import encode_bytes, run_unit, warm_pcm


def setup(run) -> None:
    """The warm-up: the cell's own full-batch shape, three batches of 64
    frames, one eager call and the capture."""
    encode_bytes(run, warm_pcm(run, 3 * 64))


def drive(run, window) -> None:
    """Encode each (pcm, start, n) of the source into its own stream until
    the window closes and the file it cut is finished. Keeps the files in
    run.state["files"]: stream bytes, where the PCM came from, the wall
    from `StreamEncoder(...)` through `finish()`, whether it finished
    inside the window, and the error it raised (VerifyError)."""
    from flac_tpu_torch.encode.encoder import StreamEncoder, VerifyError
    cfg, step, lsb = run.conf, run.step, run.control == "lsb"
    out = run.state["files"] = []
    for pcm, start, n in run.source.files:
        if not window.open:
            break
        rec = dict(start=start, n=n, data=None, error=None, in_window=False, wall_s=None)
        out.append(rec)
        t_open = time.perf_counter()
        sink = io.BytesIO()
        try:
            with window.unit("encode.open"):
                enc = StreamEncoder(cfg.encoder, sink, total_samples_estimate=n,
                                    verify=cfg.verify, device=run.device)
            for s in range(0, n, step):
                chunk = pcm[start + s:start + min(s + step, n)]
                if lsb:
                    chunk = chunk & ~1
                # the stream's header, written when the encoder was made,
                # counts with the first unit
                run_unit(window, "encode.process", enc, sink, lambda: enc.process(chunk),
                         header=s == 0)
            run_unit(window, "encode.finish", enc, sink, enc.finish)
        except VerifyError as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            continue
        rec["wall_s"] = time.perf_counter() - t_open
        rec["in_window"] = window.open or (window.t_close is not None
                                           and t_open + rec["wall_s"] <= window.t_close)
        rec["data"] = sink.getvalue()


def result(run, rec: dict) -> tuple[int, int]:
    done = run.state["files"]
    rec["file_walls_ms"] = [f["wall_s"] * 1e3 for f in done if f["in_window"]]
    return len(done), sum(f["error"] is not None for f in done)


def check(run) -> dict:
    numbers = checks.check_encode(run.state.pop("files"), run.source.pcm, run.conf,
                                  traffic.rng(run.seed, "check", 1), run.device)
    return numbers
