"""The program's encode pipeline counters (flac_tpu_torch.encode.encoder's
`pipeline_batches`, `pipelined_batches`, `pipeline_wait_ns`), each 0 where
the program has none: harness.program_counters raises on a counter the
program lacks, so the reader names these instead, and returns nothing
where no batch of full frames was launched."""

from __future__ import annotations

import importlib

NAMES = ("pipeline_batches", "pipelined_batches", "pipeline_wait_ns")


class _Counters:
    def __getattr__(self, name: str) -> int:
        if name not in NAMES:
            raise AttributeError(name)
        return getattr(importlib.import_module("flac_tpu_torch.encode.encoder"), name, 0)


program = _Counters()

COUNTERS = {k: [f"cardbench.metrics._pipeline:program.{k}"] for k in NAMES}
