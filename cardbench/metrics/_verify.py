"""The program's verify counters (flac_tpu_torch.encode.encoder's
`verified_frames`, `verify_host_frames`, `verify_ns`), each 0 where the
program has none: harness.program_counters raises on a counter the program
lacks, so the readers name these instead, and return nothing where the
program verified no frame."""

from __future__ import annotations

import importlib

NAMES = ("verified_frames", "verify_host_frames", "verify_ns")


class _Counters:
    def __getattr__(self, name: str) -> int:
        if name not in NAMES:
            raise AttributeError(name)
        return getattr(importlib.import_module("flac_tpu_torch.encode.encoder"), name, 0)


program = _Counters()

COUNTERS = {k: [f"cardbench.metrics._verify:program.{k}"] for k in NAMES}
