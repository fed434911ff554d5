"""Explicit device selection: a requested CUDA device without a card
raises; nothing drops to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but "
                               "torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev


_CONSTANTS: dict = {}


def device_constant(key: tuple, make, device: torch.device) -> torch.Tensor:
    """A constant table (``make()``: a numpy array) on ``device``, made once
    per (key, device) and kept. It is made outside inference mode, so a
    train step may save it for its backward after an eval step made it, and
    a captured step finds it made by its warm-up: a capture copies nothing
    from the host."""
    full = (*key, str(device))
    t = _CONSTANTS.get(full)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(make(), device=device)
        _CONSTANTS[full] = t
    return t
