"""Device selection for the port's entry points.

Every entry point takes ``device`` and runs on the card unless the caller
asks for the CPU.  There is no silent fallback: asking for ``"cuda"`` on a
machine without a card is an error, never a CPU run.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` (``"cuda"`` unless ``"cpu"`` is
    asked for); raises ``RuntimeError`` when CUDA is asked for and there
    is no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain version")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev
