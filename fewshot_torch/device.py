"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU by name:
``device=None`` means ``"cuda"``, and a CUDA request without a card raises
instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fewshot_torch needs a CUDA device (no card is visible); pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return dev
