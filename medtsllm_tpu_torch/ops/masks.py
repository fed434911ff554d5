"""Attention masks (port of ``medtsllm_tpu/ops/masks.py``): the causal mask
and ``prob_mask``, its rows at ``ProbAttention``'s top-u queries."""

from __future__ import annotations

import torch


def triangular_causal_mask(L: int, S: int | None = None, device=None) -> torch.Tensor:
    """Boolean [L, S], True where masked (above the diagonal)."""
    S = S if S is not None else L
    return torch.ones(L, S, dtype=torch.bool, device=device).triu(1)


def prob_mask(L: int, index: torch.Tensor, scores_shape) -> torch.Tensor:
    """The causal mask's rows at the query positions ``index`` [B, H, u]:
    [B, H, u, S], S = ``scores_shape[-1]``."""
    return triangular_causal_mask(L, scores_shape[-1], index.device)[index]
