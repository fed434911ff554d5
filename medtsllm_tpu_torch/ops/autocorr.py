"""Auto-correlation (port of ``medtsllm_tpu/ops/autocorr.py``:
``AutoCorrelation`` and the projection wrapper ``AutoCorrelationLayer``).

The correlation q * conj(k) goes through the basis DFT (``ops/dft.py``);
``top_k = int(factor * log L)`` is static, and the delays stay device
indices: shared over the batch in training (the reference's training
branch), per row in eval. The reference's per-delay ``torch.roll`` loop is
one gather at the delays and a weighted sum.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.llm.transformer import Linear
from .dft import irfft_ri, rfft_ri
from .transformer import borrow


def delay_gather(values: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """values [B, H, E, L], delays [k] (shared) or [B, k] (per row) ->
    [k, B, H, E, L], pattern i at t = values[(t + delay_i) % L] (that is,
    ``torch.roll(values, -delay_i, -1)``)."""
    L = values.shape[-1]
    t = torch.arange(L, device=values.device)
    if delays.dim() == 1:
        idx = (t[None, :] + delays[:, None]) % L  # [k, L]
        return values[..., idx].permute(3, 0, 1, 2, 4)
    B, H, E, _ = values.shape
    idx = (t[None, None, :] + delays[:, :, None]) % L  # [B, k, L]
    k = idx.shape[1]
    gathered = torch.gather(values[:, None].expand(B, k, H, E, L), -1,
                            idx[:, :, None, None, :].expand(B, k, H, E, L))
    return gathered.transpose(0, 1)


class AutoCorrelation(nn.Module):
    """Period-based dependencies by the FFT cross-correlation, then the
    time-delay aggregation: queries [B, L, H, E], keys / values [B, S, H, E]
    (cut or zero-padded to L) -> ([B, L, H, E], the correlation
    [B, L, H, E] with ``output_attention``, else None)."""

    def __init__(self, factor: int = 1, output_attention: bool = False):
        super().__init__()
        self.factor, self.output_attention = factor, output_attention

    def forward(self, queries, keys, values, attn_mask=None, generator=None):
        B, L, H, E = queries.shape
        S = values.shape[1]
        if L > S:
            pad = torch.zeros(B, L - S, H, E, dtype=values.dtype, device=values.device)
            values = torch.cat([values, pad], dim=1)
            keys = torch.cat([keys, pad], dim=1)
        else:
            values, keys = values[:, :L], keys[:, :L]
        q = queries.permute(0, 2, 3, 1)  # [B, H, E, L]
        k = keys.permute(0, 2, 3, 1)
        v = values.permute(0, 2, 3, 1)
        qre, qim = rfft_ri(q)
        kre, kim = rfft_ri(k)
        corr = irfft_ri(qre * kre + qim * kim, qim * kre - qre * kim, n=L)

        top_k = int(self.factor * math.log(L))
        mean_value = corr.mean(dim=1).mean(dim=1)  # [B, L]
        if self.training:  # delays shared over the batch, weights per row
            delays = torch.topk(mean_value.mean(dim=0), top_k).indices
            weights = mean_value[:, delays]
        else:  # per-row delays
            weights, delays = torch.topk(mean_value, top_k)
        tmp_corr = torch.softmax(weights, dim=-1)  # [B, k]
        patterns = delay_gather(v, delays)
        agg = torch.einsum("kbhel,bk->bhel", patterns, tmp_corr.to(patterns.dtype))
        V = agg.permute(0, 3, 1, 2).to(values.dtype)
        return V, (corr.permute(0, 3, 1, 2) if self.output_attention else None)


class AutoCorrelationLayer(nn.Module):
    """The q / k / v projections to ``n_heads`` heads, the borrowed inner
    correlation (``inner_correlation``: a module the model registers, which
    layers may share, as FEDformer's Fourier blocks are) and the output
    projection. As in the reference, the inner block's output is flattened
    to [B, L, -1] whatever its layout (FourierBlock's is [B, H, E, L]): a
    part of FEDformer's published semantics."""

    def __init__(self, inner_correlation: nn.Module, d_model: int, n_heads: int,
                 d_keys: int | None = None, d_values: int | None = None):
        super().__init__()
        d_keys = d_keys or d_model // n_heads
        d_values = d_values or d_model // n_heads
        self.n_heads = n_heads
        borrow(self, "inner_correlation", inner_correlation)
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
        out, attn = self.inner_correlation(q, k, v, attn_mask, generator)
        return self.out_projection(out.reshape(B, L, -1)), attn
