"""RevIN: reversible per-window instance normalization (port of
``medtsllm_tpu/ops/revin.py::revin_norm/revin_denorm/masked_window_norm``).
The statistics are returned explicitly; they are detached, as the
reference detaches them.
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


def masked_window_norm(x: torch.Tensor, mask: torch.Tensor):
    """Imputation's mask-aware window normalization: the statistics over the
    observed points only (``mask`` 1), both detached; ``x`` zero-filled at
    the held-out points. x, mask [B, L, C] -> (x_norm, means, stdev), the
    statistics [B, 1, C]."""
    m = mask.to(x.dtype)
    cnt = m.sum(dim=1, keepdim=True).clamp(min=1.0)
    means = (x.sum(dim=1, keepdim=True) / cnt).detach()
    xc = (x - means) * m
    stdev = torch.sqrt((xc * xc).sum(dim=1, keepdim=True) / cnt + 1e-5).detach()
    return xc / stdev, means, stdev
