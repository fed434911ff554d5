"""RevIN: reversible per-window instance normalization (port of
``medtsllm_tpu/ops/revin.py::revin_norm/revin_denorm``). The statistics
are returned explicitly; they are detached, as the reference detaches them.
"""

from __future__ import annotations

import torch


def revin_norm(x: torch.Tensor, eps: float = 1e-5):
    """x [B, L, C] -> (normalized x, {"center", "stdev"} each [B, 1, C]);
    population variance over the time axis."""
    center = x.mean(dim=1, keepdim=True).detach()
    var = x.var(dim=1, keepdim=True, unbiased=False)
    stdev = torch.sqrt(var + eps).detach()
    return (x - center) / stdev, {"center": center, "stdev": stdev}


def revin_denorm(y: torch.Tensor, stats: dict) -> torch.Tensor:
    return y * stats["stdev"] + stats["center"]
