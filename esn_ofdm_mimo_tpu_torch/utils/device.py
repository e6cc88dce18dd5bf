"""The port's device policy for entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Entry-point device: "cuda" unless the caller asks for another.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    a run never drops to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
