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
