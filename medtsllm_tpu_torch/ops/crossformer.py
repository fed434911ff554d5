"""Crossformer's two-stage attention layer (port of
``medtsllm_tpu/ops/crossformer.py``).

Input and output [B, D, L, d_model] (D variables, L segments): stage 1
attends across the segments of each variable, stage 2 sends each
segment's variables through ``factor`` learned router tokens and back.
JAX's choices are kept where the reference differs: the MLPs' GELU is the
tanh form (flax's ``gelu(approximate=True)``), the LayerNorms take flax's
epsilon, and the ``router`` parameter [seg_num, factor, d_model] is tiled
over the batch, so L must equal ``seg_num``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.llm.transformer import LayerNorm, Linear, dropout
from .attention import AttentionLayer, FullAttention


class TwoStageAttentionLayer(nn.Module):
    """``time_attention``, ``dim_sender`` and ``dim_receiver`` (unmasked
    ``FullAttention`` layers), the MLPs ``MLP1_fc1/fc2`` and ``MLP2_fc1/fc2``
    (d_model -> d_ff -> d_model), ``norm1`` ... ``norm4``; dropout ``p`` on
    each residual branch and ``attention_p`` on the attention weights in
    training."""

    def __init__(self, seg_num: int, factor: int, d_model: int, n_heads: int,
                 d_ff: int | None = None, p: float = 0.1, attention_p: float = 0.1):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.p = p
        for name in ("time_attention", "dim_sender", "dim_receiver"):
            setattr(self, name, AttentionLayer(FullAttention(mask_flag=False, p=attention_p),
                                               d_model, n_heads))
        self.router = nn.Parameter(torch.empty(seg_num, factor, d_model))
        for name in ("MLP1", "MLP2"):
            setattr(self, f"{name}_fc1", Linear(d_model, d_ff))
            setattr(self, f"{name}_fc2", Linear(d_ff, d_model))
        for i in range(1, 5):
            setattr(self, f"norm{i}", LayerNorm(d_model))

    def _drop(self, x, generator):
        return dropout(x, self.p, generator) if self.training else x

    def _mlp(self, name, x):
        h = F.gelu(getattr(self, f"{name}_fc1")(x), approximate="tanh")
        return getattr(self, f"{name}_fc2")(h)

    def forward(self, x, attn_mask=None, generator=None):
        B, D, L, dm = x.shape
        time_in = x.reshape(B * D, L, dm)
        time_enc, _ = self.time_attention(time_in, time_in, time_in, None, generator)
        dim_in = self.norm1(time_in + self._drop(time_enc, generator))
        dim_in = self.norm2(dim_in + self._drop(self._mlp("MLP1", dim_in), generator))

        dim_send = dim_in.reshape(B, D, L, dm).transpose(1, 2).reshape(B * L, D, dm)
        batch_router = self.router.repeat(B, 1, 1)  # [(B L), factor, d_model]
        dim_buffer, _ = self.dim_sender(batch_router, dim_send, dim_send, None, generator)
        dim_receive, _ = self.dim_receiver(dim_send, dim_buffer, dim_buffer, None, generator)
        dim_enc = self.norm3(dim_send + self._drop(dim_receive, generator))
        dim_enc = self.norm4(dim_enc + self._drop(self._mlp("MLP2", dim_enc), generator))
        return dim_enc.reshape(B, L, D, dm).transpose(1, 2)
