"""The port's device policy for entry points, and its device constants."""
from __future__ import annotations

import torch

_CONSTANTS: dict = {}


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


def device_constant(make, *args, device=None) -> torch.Tensor:
    """torch.as_tensor(make(*args)) on `device`, made once for each (make,
    args, device) and shared after that; callers never write to it. An
    argument that does not hash (an LdpcCode of NumPy arrays) keys by its
    identity: the entry holds it, so its id is not reused while the entry
    lives. Host data reaches the card by a copy that syncs the stream,
    which a CUDA graph capture cannot hold, so a constant that a captured
    round uses is copied once, before the capture."""
    dev = torch.device("cpu" if device is None else device)
    key = (make, tuple(_by_value_or_id(a) for a in args), dev)
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS[key] = (args, torch.as_tensor(make(*args),
                                                       device=dev))
    return hit[1]


def _by_value_or_id(arg):
    try:
        hash(arg)
    except TypeError:
        return ("id", id(arg))
    return arg
