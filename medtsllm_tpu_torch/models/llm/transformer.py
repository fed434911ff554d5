"""The llama decoder (port of ``medtsllm_tpu/models/llm/transformer.py``:
RMSNorm, rotary, QuantDense w8a8 / w4a8 / plain Dense, Attention, the SwiGLU MLP,
the mixtral-style sparse-MoE FFN (``MoEMLP``, single device, serving), the
pre-norm Block and TransformerDecoder with ``prefill``).

Dtypes follow the JAX module's: parameters are stored at the storage dtype
(f32 or bf16); ``dtype`` (None for f32, else the compute dtype) is where
projections emit and attention runs, while the residual stream keeps the
promoted type of the input embeddings (f32), as flax promotion does.
Attention (prefill included) goes through the fused RoPE + prefix + causal
kernel (K2) up to ``K4_MIN_KEYS`` keys, and above that, or past K2's 2048,
through the flash-attention route (K4 with the rotation, the head
transpose and the prefix concat of JAX's unfused path folded in); every
projection at ``quantize=8`` through the
w8a8 kernel (K1), at ``quantize=4`` with the absmax codebook through K1's
quantizer and the w4a8 kernel (K5). The MoE FFN routes each token to its
top-k experts and runs them either as the dropless grouped chain (K6,
``moe_grouped``, int8 or absmax int4 experts) or as the static-capacity
per-expert bmm (K1 per expert for integer experts).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.flash_attention import rope_flash_attention
from ...ops.kernels.grouped_matmul import (gmm, gmm_metadata, gmm_visits, pick_block_n,
                                            row_quant)
from ...ops.kernels.rope_attention import MAX_KEYS, rope, rope_attention, rope_tables
from ...ops.kernels.w4a8 import act_quant_w4a8_matmul, dequant_codebook, unpack4_split
from ...ops.kernels.w8a8 import act_quant_matmul, int8_gemm, quantize_rows
from .config import DecoderConfig


# Least key count (prefix + region) at which an attention that needs no
# gradient takes the K4 route in place of K2; K4 also takes every call past
# K2's MAX_KEYS. Set from the route table of chip_smoke.py phase 3 on an
# H100 (the 7B layout, batch 8, a 37-token prefix; PERF.md §6): the route
# (the pre-pass, then K4 with q rotated at load) beats the tensor-core K2 at
# every listed count, 512, 1024 and 2048 keys, so K4 takes every call from
# 512 keys on. The main path (149 keys) and the MoE path (158) stay on K2.
K4_MIN_KEYS = 512


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight


class QuantLinear(nn.Module):
    """Quantized projection (JAX QuantDense with act_quant): per-channel
    scale [N], the weight transposed from the JAX kernel_q.

    bits=8: int8 weight [N, K]; w8a8 (K1), activations quantized per row.
    bits=4: split-halves packed int4 [N, ceil(K/2)], three routes as in
    ``QuantDense.__call__``: the absmax codebook with K even runs K1's
    quantizer and K5; with K odd, the unpacked weight on K1; the bnb
    codebooks ("nf4", "fp4") a table dequant and ``(x @ w) * scale`` at the
    compute dtype (weight-only, as JAX's XLA dot). The f32 product is
    rounded to ``dtype`` (the input's dtype when None), as JAX casts the f32
    result. Forward only at bits=4: the straight-through backward of K5 is
    not ported."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype | None = None,
                 bits: int = 8, codebook: str = "absmax"):
        super().__init__()
        self.dtype, self.d_in, self.bits = dtype, d_in, bits
        self.codebook = codebook if bits == 4 else "absmax"
        cols = d_in if bits == 8 else (d_in + 1) // 2
        self.register_buffer("weight_q", torch.zeros(d_out, cols, dtype=torch.int8))
        self.scale = nn.Parameter(torch.ones(d_out), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or x.dtype
        if self.bits == 8:
            return act_quant_matmul(x, self.weight_q, self.scale, cd)
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "training through 4-bit projections (the straight-through backward "
                "of the w4a8 GEMM) is ROADMAP queue 1, \"Training on the served backbones\"")
        if self.codebook != "absmax":
            w = dequant_codebook(self.weight_q, self.d_in, self.codebook).to(cd)
            return (x.to(cd) @ w.T) * self.scale.to(cd)
        if self.d_in % 2:
            return act_quant_matmul(x, unpack4_split(self.weight_q, self.d_in),
                                    self.scale, cd)
        return act_quant_w4a8_matmul(x, self.weight_q, self.scale, cd)


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


def projection(d_in: int, d_out: int, quantize: int, dtype,
               codebook: str = "absmax") -> nn.Module:
    if quantize:
        return QuantLinear(d_in, d_out, dtype, quantize, codebook)
    return Linear(d_in, d_out, bias=False, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        cb = cfg.quant4_codebook
        self.q_proj = projection(cfg.d_model, H * D, quantize, dtype, cb)
        self.k_proj = projection(cfg.d_model, KV * D, quantize, dtype, cb)
        self.v_proj = projection(cfg.d_model, KV * D, quantize, dtype, cb)
        self.o_proj = projection(H * D, cfg.d_model, quantize, dtype, cb)

    def forward(self, x, prefix_kv=None, position_offset: int = 0,
                return_kv: bool = False):
        """x [B, L, d]. ``prefix_kv`` = (k, v) each [1 or B, KV, P, D],
        already rotated at positions 0..P-1, with x at positions P.. (pass
        ``position_offset=P``). ``return_kv`` also returns this call's
        rotated (k, v) [B, KV, L, D] — the prefill cache.

        The route: K2 when the call has at most ``K4_MIN_KEYS - 1`` keys and
        at most K2's ``MAX_KEYS``, else K4's route (``rope_flash_attention``,
        ``transformer.py:591-633`` of the JAX package). K4 has no
        backward, so a call that needs a gradient keeps K2 and raises past
        its key limit."""
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
        keys = L + (pk.shape[2] if pk is not None else 0)
        sm_scale = 1.0 / math.sqrt(D)
        needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        if needs_grad and keys > MAX_KEYS:
            raise NotImplementedError(
                f"training through attention over {keys} keys needs a backward of the "
                "flash-attention kernel, which the JAX package does not have (ROADMAP "
                "queue 1, \"Training on the served backbones\")")
        new_kv = None
        if not needs_grad and (keys > MAX_KEYS or keys >= K4_MIN_KEYS):
            out = rope_flash_attention(q, k, v, cos, sin, pk, pv, sm_scale, return_kv)
            if return_kv:
                out, new_kv = out
        else:
            out = rope_attention(q, k, v, cos, sin, pk, pv, sm_scale)
            if return_kv:
                new_kv = (rope(k, cos, sin).transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous())
        out = self.o_proj(out.reshape(B, L, H * D))
        return (out, new_kv) if return_kv else out


class MLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        cb = cfg.quant4_codebook
        self.gate_proj = projection(cfg.d_model, cfg.d_ff, quantize, dtype, cb)
        self.up_proj = projection(cfg.d_model, cfg.d_ff, quantize, dtype, cb)
        self.down_proj = projection(cfg.d_ff, cfg.d_model, quantize, dtype, cb)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    """Static per-expert slot count. factor <= 0 means dropless: top_k
    gives each token at most one slot per expert, so capacity = n_tokens
    is exact. Positive factors give the GShard bound ceil(k*T/E * f),
    rounded up to a multiple of 8, capped at T."""
    if factor <= 0:
        return n_tokens
    cap = math.ceil(top_k * n_tokens / n_experts * factor)
    return min(((cap + 7) // 8) * 8, n_tokens)


def act_quant_bmm(h: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-expert w8a8 matmul with per-row activation quantization (the
    forward of ``transformer.py::_act_quant_bmm``): h [E, C, K] f32, wq
    [E, N, K] int8, scale [E, N] -> [E, C, N] f32 = acc * (x_scale *
    scale). K1's quantizer over the E*C rows, then K1's GEMM per expert.
    Forward only: the straight-through backward comes with MoE training."""
    E, C, K = h.shape
    xq, xs = quantize_rows(h.reshape(E * C, K).contiguous())
    xq, xs, ws = xq.reshape(E, C, K), xs.reshape(E, C), scale.float()
    return torch.stack([int8_gemm(xq[e], wq[e], xs[e], ws[e].contiguous())
                        for e in range(E)])


def pack_and_run_gmm(xt, src, dest, n_slots, ve, valid, V, bm, bn_f, bn_d, wb,
                     kg, sg, ku, su, kd, sd):
    """Quantize before dispatch, pack by gather, run the fused-requant gmm
    chain (``transformer.py::_pack_and_run_gmm``). xt [T, D] at the compute
    dtype (its per-row quantization reads the JAX ``astype(cd)`` round
    trip); ``dest`` [n_slots] the packed row of each (token, slot). The one
    scatter builds the int32 inverse permutation; tile tails point at a zero
    row with the 1e-10 scale floor. ``wb`` is the experts' weight width (8,
    or 4 for packed int4). Returns the down-gmm output [V*bm, D] (f32)."""
    n_rows, D = xt.shape
    xq_t, xs_t = row_quant(xt)
    inv = torch.full((V * bm,), n_slots, dtype=torch.int32, device=xt.device)
    inv[dest] = torch.arange(n_slots, dtype=torch.int32, device=xt.device)
    tok = torch.cat([src.to(torch.int32), inv.new_full((1,), n_rows)])[inv]
    xq = torch.cat([xq_t, xq_t.new_zeros(1, D)])[tok]
    xs = torch.cat([xs_t, xs_t.new_full((1, 1), 1e-10)])[tok]
    # SwiGLU epilogue + per-(row, F-tile) requant in the first gmm, whose
    # int8 rows and chunked scales feed the down gmm
    aq, as_ = gmm(xq, xs, (kg, ku), (sg, su), ve, valid, block_m=bm, block_n=bn_f,
                  fuse_silu=True, emit_quant=True, w_bits=wb)
    (y,) = gmm(aq, as_, (kd,), (sd,), ve, valid, block_m=bm, block_n=bn_d, w_bits=wb)
    return y


class MoEMLP(nn.Module):
    """Mixtral-style sparse-MoE SwiGLU FFN (``transformer.py::MoEMLP``,
    single device, serving): router softmax in f32, top-k of the
    probabilities renormalized, rank within expert by a cumsum over the
    one-hot assignment. Experts run either as the dropless grouped chain
    (``moe_grouped`` with int8 or absmax int4 experts, in eval: K6 twice) or
    as the static-capacity dispatch into an [E, C, d] buffer, slots beyond C
    dropped in token order, then E-batched matmuls (K1 per expert for int8
    and absmax int4 experts, the int4 unpacked first; a table dequant and
    ``torch.bmm`` for the nf4 / fp4 codebooks; ``torch.bmm`` for dense
    experts).

    Parameters: ``gate`` [D, E]; int8 experts ``w_{gate,up,down}_q``
    [E, N, K] (the kernels' layout, the transpose of JAX's [E, K, N]) or
    packed int4 [E, N, ceil(K/2)], with scales [E, N]; dense experts
    ``w_{gate,up,down}`` [E, K, N] (JAX's layout)."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        self.cfg, self.quantize, self.dtype = cfg, quantize, dtype
        E, D, d_ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.gate = nn.Parameter(torch.zeros(D, E))
        shapes = {"w_gate": (D, d_ff), "w_up": (D, d_ff), "w_down": (d_ff, D)}
        for name, (d_in, d_out) in shapes.items():
            if quantize:
                cols = d_in if quantize == 8 else (d_in + 1) // 2
                self.register_buffer(name + "_q",
                                     torch.zeros(E, d_out, cols, dtype=torch.int8))
                setattr(self, name + "_scale",
                        nn.Parameter(torch.ones(E, d_out), requires_grad=False))
            else:
                setattr(self, name, nn.Parameter(torch.zeros(E, d_in, d_out)))

    def _grouped(self, xt, eid, pos, src, cd):
        """The dropless grouped chain -> per-(token, slot) outputs [T*k, D]
        at ``cd``, or None when the widths have no multiple-of-128 block
        (the caller takes the capacity path)."""
        cfg = self.cfg
        T, D = xt.shape
        E, k, F_ = cfg.n_experts, cfg.n_experts_per_tok, cfg.d_ff
        # gate/up at the widest tile, down at 1024 (grouped_matmul.py's
        # choice; block_n sets the requant tile)
        bn_f, bn_d = pick_block_n(F_, target=1408), pick_block_n(D, 1024)
        if not (bn_f and bn_d):
            return None
        wb = self.quantize
        if wb == 4:
            # JAX's packed-int4 fallback conditions (transformer.py:887-891):
            # even contraction widths, an even chunk count for the down gmm
            # (no chunk straddles the nibble halves), the down block at 512
            bn_d = pick_block_n(D, 512)
            if D % 2 or F_ % 2 or (F_ // bn_f) % 2 or not bn_d:
                return None
        bm = 128
        V = gmm_visits(T * k, E, bm)
        counts = torch.zeros(E, dtype=torch.int32, device=xt.device).index_add_(
            0, eid, torch.ones_like(eid, dtype=torch.int32))
        ve, valid, row_off = gmm_metadata(counts, bm, V)
        dest = row_off[eid] + pos  # dropless: every slot lands in bounds
        y = pack_and_run_gmm(xt.to(cd), src, dest, T * k, ve, valid, V, bm, bn_f, bn_d, wb,
                             self.w_gate_q, self.w_gate_scale, self.w_up_q,
                             self.w_up_scale, self.w_down_q, self.w_down_scale)
        return y[dest].to(cd)

    def _bmm(self, h, name):
        if not self.quantize:
            return torch.bmm(h, getattr(self, name).to(h.dtype))
        wq, scale = getattr(self, name + "_q"), getattr(self, name + "_scale")
        if self.quantize == 4:
            d_in, cb = h.shape[-1], self.cfg.quant4_codebook
            if cb != "absmax":  # the table dequant, a bmm at the compute dtype
                w = dequant_codebook(wq, d_in, cb).to(h.dtype)
                return torch.bmm(h, w.transpose(1, 2)) * scale[:, None, :].to(h.dtype)
            wq = unpack4_split(wq, d_in)
        return act_quant_bmm(h.float(), wq, scale).to(h.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "training through a MoE backbone (the straight-through backward "
                "of the expert matmuls, router_aux_loss) is ROADMAP queue 1, "
                "\"Training on the served backbones\"")
        cfg = self.cfg
        E, k = cfg.n_experts, cfg.n_experts_per_tok
        B, L, D = x.shape
        T = B * L
        cd = self.dtype or x.dtype
        xt = x.reshape(T, D)
        probs = torch.softmax(xt.float() @ self.gate.float(), dim=-1)
        # jax.lax.top_k keeps the lower index first among equal values; a
        # stable descending sort does too (torch.topk does not promise it)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :k], top_i[:, :k]
        weights = (top_p / top_p.sum(dim=-1, keepdim=True)).reshape(T * k)
        eid = top_i.reshape(T * k)
        # rank of each slot within its expert: a running count over the slots,
        # taken along the inner axis of an [E, T*k] one-hot (a cumsum over the
        # outer axis of [T*k, E] is a slow kernel on the card)
        onehot = (eid[None, :] == torch.arange(E, device=x.device)[:, None]).to(torch.int32)
        pos = ((torch.cumsum(onehot, 1, dtype=torch.int32) - onehot) * onehot).sum(0)
        src = torch.arange(T, device=x.device).repeat_interleave(k)

        int_experts = self.quantize == 8 or (self.quantize == 4
                                             and cfg.quant4_codebook == "absmax")
        if cfg.moe_grouped and int_experts and not self.training:
            y = self._grouped(xt, eid, pos, src, cd)
            if y is not None:
                return (y * weights[:, None].to(cd)).reshape(T, k, D).sum(1).reshape(B, L, D)

        C = moe_capacity(T, E, k, cfg.expert_capacity)
        keep = pos < C
        dest = torch.where(keep, eid * C + pos, E * C)  # drops -> the trash row
        buf = torch.zeros(E * C + 1, D, dtype=cd, device=x.device)
        buf[dest] = xt[src].to(cd)
        h = buf[:E * C].reshape(E, C, D)
        g, u = self._bmm(h, "w_gate"), self._bmm(h, "w_up")
        out = self._bmm(F.silu(g) * u, "w_down")  # [E, C, D]
        out_flat = torch.cat([out.reshape(E * C, D), out.new_zeros(1, D)])
        y = out_flat[dest] * (weights * keep.float())[:, None].to(cd)
        return y.reshape(T, k, D).sum(1).reshape(B, L, D)


class Block(nn.Module):
    """Pre-norm llama block; the FFN is the MoE one when the config has
    more than one expert."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.attn = Attention(cfg, quantize, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.mlp = (MoEMLP if cfg.n_experts > 1 else MLP)(cfg, quantize, dtype)

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
                "ROADMAP queue 1, \"Other backbone families and LoRA\"")
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
