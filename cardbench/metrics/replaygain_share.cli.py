"""Percent of the traced window's time that the `flac` command spent tagging
the album with ReplayGain (the program's `replaygain_ns`: host clock inside
`add_replay_gain_tags`, the decodes back, the filter, the copies back, the
window statistics and the tag rewrites). Both are read over the traced
window, whose counters are read just after the tracer stops and whose time
ends before the stop, so the stop's own time is in neither; nothing where
no title was analysed there (`replaygain_titles`), as in a program without
the counters."""

from cardbench.metrics import _replaygain

COUNTERS = _replaygain.COUNTERS


def read(rec):
    c, window_s = rec["trace_counters"], rec["trace"]["window_s"]
    if not c["replaygain_titles"] or not window_s:
        return None
    return 100.0 * c["replaygain_ns"] / 1e9 / window_s
