"""Percent of the stream encoder's batches of full frames launched in the
traced window while an earlier batch of the same stream was still
unfinished (the program's `pipelined_batches` per 100 `pipeline_batches`);
nothing where no batch was launched there, as in a program without the
counters."""

from cardbench.metrics import _pipeline

COUNTERS = _pipeline.COUNTERS


def read(rec):
    c = rec["trace_counters"]
    if not c["pipeline_batches"]:
        return None
    return 100.0 * c["pipelined_batches"] / c["pipeline_batches"]
