"""The llama decoder (port of ``medtsllm_tpu/models/llm/transformer.py``:
RMSNorm, rotary, QuantDense w8a8 / plain Dense, Attention, the SwiGLU MLP,
the pre-norm Block and TransformerDecoder with ``prefill``; dense llama
only).

Dtypes follow the JAX module's: parameters are stored at the storage dtype
(f32 or bf16); ``dtype`` (None for f32, else the compute dtype) is where
projections emit and attention runs, while the residual stream keeps the
promoted type of the input embeddings (f32), as flax promotion does.
Attention (all calls, prefill included) goes through the fused RoPE +
prefix + causal kernel; every projection at ``quantize=8`` through the
w8a8 kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.rope_attention import rope, rope_attention, rope_tables
from ...ops.kernels.w8a8 import act_quant_matmul
from .config import DecoderConfig


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight


class QuantLinear(nn.Module):
    """w8a8 projection (JAX QuantDense bits=8 with act_quant): int8 weight
    [N, K] (transposed from the JAX [K, N] kernel_q), per-channel scale
    [N]; activations quantized per row inside the kernel. The f32 product
    is rounded to ``dtype`` (the input's dtype when None) in the kernel's
    epilogue, as JAX casts the f32 result."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(d_out, d_in, dtype=torch.int8))
        self.scale = nn.Parameter(torch.ones(d_out), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act_quant_matmul(x, self.weight_q, self.scale, self.dtype or x.dtype)


class Linear(nn.Linear):
    """flax ``nn.Dense``: computes at ``dtype``, or at the promoted type of
    input and weight when ``dtype`` is None."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def projection(d_in: int, d_out: int, quantize: int, dtype) -> nn.Module:
    if quantize == 8:
        return QuantLinear(d_in, d_out, dtype)
    if quantize:
        raise NotImplementedError(
            f"quantize={quantize}: 4-bit weights are ROADMAP queue 1 item 10")
    return Linear(d_in, d_out, bias=False, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.q_proj = projection(cfg.d_model, H * D, quantize, dtype)
        self.k_proj = projection(cfg.d_model, KV * D, quantize, dtype)
        self.v_proj = projection(cfg.d_model, KV * D, quantize, dtype)
        self.o_proj = projection(H * D, cfg.d_model, quantize, dtype)

    def forward(self, x, prefix_kv=None, position_offset: int = 0,
                return_kv: bool = False):
        """x [B, L, d]. ``prefix_kv`` = (k, v) each [1 or B, KV, P, D],
        already rotated at positions 0..P-1, with x at positions P.. (pass
        ``position_offset=P``). ``return_kv`` also returns this call's
        rotated (k, v) [B, KV, L, D] — the prefill cache."""
        cfg = self.cfg
        B, L, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.dtype is not None:  # cast before the head split, as JAX does
            q, k, v = q.to(self.dtype), k.to(self.dtype), v.to(self.dtype)
        q = q.reshape(B, L, H, D)
        k = k.reshape(B, L, KV, D)
        v = v.reshape(B, L, KV, D)
        positions = torch.arange(position_offset, position_offset + L,
                                 device=x.device)
        cos, sin = rope_tables(positions, D, cfg.rope_theta)
        pk, pv = prefix_kv if prefix_kv is not None else (None, None)
        out = rope_attention(q, k, v, cos, sin, pk, pv, 1.0 / math.sqrt(D))
        out = self.o_proj(out.reshape(B, L, H * D))
        if not return_kv:
            return out
        new_kv = (rope(k, cos, sin).transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous())
        return out, new_kv


class MLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        self.gate_proj = projection(cfg.d_model, cfg.d_ff, quantize, dtype)
        self.up_proj = projection(cfg.d_model, cfg.d_ff, quantize, dtype)
        self.down_proj = projection(cfg.d_ff, cfg.d_model, quantize, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    """Pre-norm llama block."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.attn = Attention(cfg, quantize, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.mlp = MLP(cfg, quantize, dtype)

    def forward(self, x, prefix_kv=None, position_offset: int = 0,
                return_kv: bool = False):
        a = self.attn(self.input_layernorm(x), prefix_kv, position_offset, return_kv)
        new_kv = None
        if return_kv:
            a, new_kv = a
        x = x + a
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, new_kv) if return_kv else x


class TransformerDecoder(nn.Module):
    """Returns the last hidden state (no LM head), like HF ``AutoModel``."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        if cfg.style != "llama":
            raise NotImplementedError(
                f"decoder style {cfg.style!r}: other backbone families are "
                "ROADMAP queue 1 item 8")
        self.cfg = cfg
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model),
                                requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, quantize, dtype)
                                    for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps)

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.wte[token_ids]

    def forward(self, inputs_embeds: torch.Tensor, prefix_kv=None) -> torch.Tensor:
        """``prefix_kv``: per-layer (k, v) from ``prefill``; inputs_embeds
        is then the suffix at positions P.."""
        x = inputs_embeds
        offset = prefix_kv[0][0].shape[2] if prefix_kv is not None else 0
        for i, block in enumerate(self.blocks):
            x = block(x, None if prefix_kv is None else prefix_kv[i], offset)
        return self.norm(x)

    def prefill(self, inputs_embeds: torch.Tensor) -> tuple:
        """Per-layer rotated (k, v) of a prompt prefix [1, P, d]."""
        x = inputs_embeds
        kvs = []
        for block in self.blocks:
            x, kv = block(x, return_kv=True)
            kvs.append(kv)
        return tuple(kvs)
