"""Percent of an encode cell's traced window in which no event ran on the
device."""

from cardbench import trace


def read(rec):
    return trace.idle_percent(rec["trace"]) if rec["loop"] == "encode" else None
