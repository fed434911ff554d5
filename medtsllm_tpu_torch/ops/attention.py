"""Softmax attention (port of ``medtsllm_tpu/ops/attention.py``:
``FullAttention`` and the projection wrapper ``AttentionLayer``).

``FullAttention`` is the plain einsum-softmax-einsum that JAX computes as
XLA ops (no Pallas kernel): the sequences here are patch counts, a few
dozen. The other inner attentions of the JAX module (``DSAttention``,
``ProbAttention``) and ``ReformerLayer`` are reached by no ported model.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.llm.transformer import Linear
from .embed import dropout
from .masks import triangular_causal_mask


class FullAttention(nn.Module):
    """queries [B, L, H, E], keys / values [B, S, H, E] -> ([B, L, H, E], the
    weights [B, H, L, S] with ``output_attention``, else None), scaled by
    1 / sqrt(E); the causal mask (or ``attn_mask``, True where masked)
    under ``mask_flag``; dropout ``p`` on the weights in training."""

    def __init__(self, mask_flag: bool = True, p: float = 0.1, output_attention: bool = False):
        super().__init__()
        self.mask_flag, self.p = mask_flag, p
        self.output_attention = output_attention

    def forward(self, queries, keys, values, attn_mask=None, generator=None):
        B, L, H, E = queries.shape
        scale = 1.0 / math.sqrt(E)
        scores = torch.einsum("blhe,bshe->bhls", queries, keys)
        if self.mask_flag:
            mask = (triangular_causal_mask(L, keys.shape[1], scores.device)
                    if attn_mask is None else attn_mask)
            scores = scores.masked_fill(mask, -math.inf)
        A = torch.softmax(scale * scores, dim=-1)
        if self.training:
            A = dropout(A, self.p, generator)
        V = torch.einsum("bhls,bshd->blhd", A, values)
        return V, (A if self.output_attention else None)


class AttentionLayer(nn.Module):
    """The q / k / v projections to ``n_heads`` heads, the inner attention
    and the output projection."""

    def __init__(self, inner_attention: nn.Module, d_model: int, n_heads: int,
                 d_keys: int | None = None, d_values: int | None = None):
        super().__init__()
        d_keys = d_keys or d_model // n_heads
        d_values = d_values or d_model // n_heads
        self.n_heads = n_heads
        self.inner_attention = inner_attention
        self.query_projection = Linear(d_model, d_keys * n_heads)
        self.key_projection = Linear(d_model, d_keys * n_heads)
        self.value_projection = Linear(d_model, d_values * n_heads)
        self.out_projection = Linear(d_values * n_heads, d_model)

    def forward(self, queries, keys, values, attn_mask=None, generator=None):
        B, L, _ = queries.shape
        S, H = keys.shape[1], self.n_heads
        q = self.query_projection(queries).reshape(B, L, H, -1)
        k = self.key_projection(keys).reshape(B, S, H, -1)
        v = self.value_projection(values).reshape(B, S, H, -1)
        out, attn = self.inner_attention(q, k, v, attn_mask, generator)
        return self.out_projection(out.reshape(B, L, -1)), attn
