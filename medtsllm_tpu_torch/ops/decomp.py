"""Trend / seasonal decomposition (port of ``medtsllm_tpu/ops/decomp.py``):
the edge-replicated moving average, ``series_decomp``, its multi-kernel
mean and the de-biased layernorm tail."""

from __future__ import annotations

import torch


def moving_avg(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Moving average over the time axis of [B, L, C]: (k - 1) // 2 copies
    of the first and last step on each end, then the windowed mean with
    stride 1, taken as a difference of cumulative sums, as JAX does (an
    even k gives L - 1 steps, as in the reference)."""
    pad = (kernel_size - 1) // 2
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x, x[:, -1:].expand(-1, pad, -1)], dim=1)
    cs = torch.cumsum(xp, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    out_len = xp.shape[1] - kernel_size + 1
    return (cs[:, kernel_size:kernel_size + out_len] - cs[:, :out_len]) / kernel_size


def series_decomp(x: torch.Tensor, kernel_size: int):
    """x -> (the seasonal residual, the trend moving mean)."""
    mean = moving_avg(x, kernel_size)
    return x - mean, mean


def series_decomp_multi(x: torch.Tensor, kernel_sizes: tuple):
    """The mean of the per-kernel seasonal and trend parts."""
    parts = [series_decomp(x, k) for k in kernel_sizes]
    return (sum(s for s, _ in parts) / len(parts), sum(m for _, m in parts) / len(parts))


def my_layernorm_bias_correction(x_hat: torch.Tensor) -> torch.Tensor:
    """A layernormed seasonal part less its mean over the time axis."""
    return x_hat - x_hat.mean(dim=1, keepdim=True)
