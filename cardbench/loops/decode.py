"""The decode loop: the streams of the source's first pass, written in
set-up by the program's own encoder at the configuration's level, decoded
in turn by `decode_bytes_device` with the MD5 checked. Units: each decode
call. The check holds the PCM of a sample of the calls against the seeded
PCM."""

from __future__ import annotations

import numpy as np

from cardbench import check as checks
from cardbench import traffic
from cardbench.loops import encode_bytes, warm_pcm

KEEP_DECODES = 4  # decode calls kept for the check, besides the longest stream's


def scan_sizes(data: bytes, n: int, conf) -> tuple[int, int]:
    """(stream bytes, samples) of the frames that the device decodes: every
    frame of the stream's blocksize, not the final partial one."""
    from cardbench.reference import flac as ref
    si, audio = ref.parse_metadata(data)
    full = n // conf.blocksize
    if n % conf.blocksize == 0:
        return len(data) - audio, n
    h = ref._headers(np.frombuffer(data, np.uint8), audio, si)
    last = h["start"][(h["number"] == full) & (h["blocksize"] == n - full * conf.blocksize)]
    return int(last.max()) - audio, full * conf.blocksize


def setup(run) -> None:
    """The streams (of the PCM with its lowest bit cleared, for the
    control), then one decode of a warm-up stream of 4 x 64 frames."""
    from flac_tpu_torch.decode.stream import decode_bytes_device
    pcm = run.source.pcm
    streams = run.state["streams"] = []
    for _ in range(run.source.per_pass):
        _, start, n = next(run.source.files)
        part = pcm[start:start + n]
        data = encode_bytes(run, part & ~1 if run.control == "lsb" else part)
        sb, ss = scan_sizes(data, n, run.conf)
        streams.append(dict(start=start, n=n, data=data, scan_bytes=sb, scan_samples=ss))
    decode_bytes_device(encode_bytes(run, warm_pcm(run, 4 * 64)), check_md5=True,
                        device=run.device)


def drive(run, window) -> None:
    """Decode the streams in turn until the window closes. Keeps each call's
    stream index and error in run.state["calls"], and in
    run.state["kept"] the outputs for the check: a reservoir of
    KEEP_DECODES calls drawn from the seed plus the last call of the
    longest stream."""
    from flac_tpu_torch.decode.host_decoder import DecodeError
    from flac_tpu_torch.decode.stream import StreamDecodeError, decode_bytes_device
    streams = run.state["streams"]
    rng = traffic.rng(run.seed, "check", 0)
    calls, kept, longest_call = [], [], None
    longest = max(range(len(streams)), key=lambda i: streams[i]["n"])
    i = 0
    while window.open:
        k = i % len(streams)
        st = streams[k]
        call = dict(stream=k, error=None)
        calls.append(call)
        try:
            with window.unit("decode.call"):
                pcm, _si, info = decode_bytes_device(st["data"], check_md5=True,
                                                     device=run.device)
            if info.get("errors"):
                call["error"] = "; ".join(info["errors"])
        except (DecodeError, StreamDecodeError) as e:
            call["error"] = f"{type(e).__name__}: {e}"
            pcm, info = None, {}
        window.add(samples=0 if pcm is None else len(pcm), scan_bytes=st["scan_bytes"],
                   scan_samples=st["scan_samples"], host_frames=info.get("host_frames", 0))
        if pcm is not None:
            if k == longest:
                longest_call = (i, pcm)
            if len(kept) < KEEP_DECODES:
                kept.append((i, pcm))
            else:
                j = int(rng.integers(0, i + 1))
                if j < KEEP_DECODES:
                    kept[j] = (i, pcm)
        i += 1
    if longest_call is not None and all(c != longest_call[0] for c, _ in kept):
        kept.append(longest_call)
    run.state["calls"], run.state["kept"] = calls, kept


def result(run, rec: dict) -> tuple[int, int]:
    calls = run.state["calls"]
    return len(calls), sum(c["error"] is not None for c in calls)


def check(run) -> dict:
    return checks.check_decode(run.state["calls"], run.state.pop("kept"),
                               run.state["streams"], run.source.pcm)
