"""The causal attention mask (port of ``medtsllm_tpu/ops/masks.py``;
``prob_mask`` serves ``ProbAttention``, which no ported model reaches)."""

from __future__ import annotations

import torch


def triangular_causal_mask(L: int, S: int | None = None, device=None) -> torch.Tensor:
    """Boolean [L, S], True where masked (above the diagonal)."""
    S = S if S is not None else L
    return torch.ones(L, S, dtype=torch.bool, device=device).triu(1)
