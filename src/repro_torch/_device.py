"""Device resolution shared by the port's entry points.

``device=None`` means the card. Without one the entry points raise
instead of running on the CPU unasked: the CPU runs only when a caller
passes ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is absent and
    a CUDA device is asked for (explicitly or by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

