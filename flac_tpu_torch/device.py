"""The port's one device rule.

`device=None` means CUDA. Without a GPU that raises: nothing drops to the
CPU on its own. The CPU runs only when the caller asks for it
(`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
