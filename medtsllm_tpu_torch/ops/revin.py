"""RevIN: reversible per-window instance normalization (port of
``medtsllm_tpu/ops/revin.py``: ``revin_norm``, ``revin_denorm``,
``RevINAffine`` and ``masked_window_norm``). The statistics are returned
explicitly; they are detached, as the reference detaches them.
"""

from __future__ import annotations

import torch
from torch import nn


def revin_norm(x: torch.Tensor, eps: float = 1e-5):
    """x [B, L, C] -> (normalized x, {"center", "stdev"} each [B, 1, C]);
    population variance over the time axis."""
    center = x.mean(dim=1, keepdim=True).detach()
    var = x.var(dim=1, keepdim=True, unbiased=False)
    stdev = torch.sqrt(var + eps).detach()
    return (x - center) / stdev, {"center": center, "stdev": stdev}


def revin_denorm(y: torch.Tensor, stats: dict) -> torch.Tensor:
    return y * stats["stdev"] + stats["center"]


class RevINAffine(nn.Module):
    """RevIN's optional per-channel affine (``affine_weight`` 1,
    ``affine_bias`` 0 at init): ``mode`` "norm" maps x * w + b, "denorm"
    (x - b) / (w + eps^2)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.affine_weight = nn.Parameter(torch.ones(num_features))
        self.affine_bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, mode: str):
        if mode == "norm":
            return x * self.affine_weight + self.affine_bias
        if mode == "denorm":
            return (x - self.affine_bias) / (self.affine_weight + self.eps * self.eps)
        raise NotImplementedError(mode)


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
