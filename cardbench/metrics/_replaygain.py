"""The program's ReplayGain counters (flac_tpu_torch.replaygain's
`replaygain_ns`, `replaygain_titles`, `replaygain_decode_ns`), each 0 where
the program has none: harness.program_counters raises on a counter the
program lacks, so the readers name these instead, and return nothing where
no title was analysed."""

from __future__ import annotations

import importlib

NAMES = ("replaygain_ns", "replaygain_titles", "replaygain_decode_ns")


class _Counters:
    def __getattr__(self, name: str) -> int:
        if name not in NAMES:
            raise AttributeError(name)
        return getattr(importlib.import_module("flac_tpu_torch.replaygain"), name, 0)


program = _Counters()

COUNTERS = {k: [f"cardbench.metrics._replaygain:program.{k}"] for k in NAMES}
