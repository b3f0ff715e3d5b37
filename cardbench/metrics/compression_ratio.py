"""Bytes of the streams written in the window over the PCM bytes they
hold, at the configuration's sample width."""


def read(rec):
    if rec["loop"] != "encode" or not rec["pcm_bytes"]:
        return None
    return rec["bytes"] / rec["pcm_bytes"]
