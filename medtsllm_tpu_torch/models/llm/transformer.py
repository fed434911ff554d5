"""The decoders (port of ``medtsllm_tpu/models/llm/transformer.py``): the
llama style (RMSNorm, rotary, bias-free projections, the SwiGLU MLP, the
mixtral-style sparse-MoE FFN ``MoEMLP``) and the LayerNorm family: gpt2
(learned positions, the fused biased ``c_attn``), opt (learned positions
from row 2, biased ``q/k/v/o_proj``, relu) and neox (partial rotary on the
leading ``rotary_dims``, the parallel residual, exact GELU); each with
QuantDense w8a8 / w4a8 / plain Dense projections (biased in the ln family),
LoRA adapters (``LoRALinear``), the pre-norm ``Block`` and
``TransformerDecoder`` with ``prefill`` (the prompt-prefix cache); the
encoder-decoders (``TransformerEncDec``: t5 with its relative-position bias
``t5_relative_buckets`` and relu / gated-gelu FFN, bart's post-LN blocks,
and llama / gpt2 styles), whose ``Block`` adds a cross-attention sublayer;
with them flax's Dense (``Linear``), LayerNorm and Dropout, which the other
models share.

Dtypes follow the JAX module's: parameters are stored at the storage dtype
(f32 or bf16); ``dtype`` (None for f32, else the compute dtype) is where
projections and the ln family's LayerNorms emit and attention runs, while
the residual stream keeps the promoted type of the input embeddings (f32),
as flax promotion does. llama attention at head dim 64 or 128 (prefill
included) goes through the fused RoPE + prefix + causal kernel (K2) up to
``K4_MIN_KEYS`` keys, and above that, or past K2's 2048, through the
flash-attention route (K4 with the rotation, the head transpose and the
prefix concat of JAX's unfused path folded in). Every other attention (the
ln family, t5, llama at other head dims, the encoders and the
cross-attention) takes JAX's own path: the rotation, the transposes and the
prefix concat, then JAX's ``flash_attention`` dispatcher as ported
(``dispatch_attention``): plain attention below 512 tokens or with t5's
bias, K4 from there. Every projection at ``quantize=8`` goes through the w8a8 kernel
(K1), at ``quantize=4`` with the absmax codebook through K1's quantizer and
the w4a8 kernel (K5). The MoE FFN routes each token to its top-k experts
and runs them either as the dropless grouped chain (K6, ``moe_grouped``,
int8 or absmax int4 experts, in eval) or as the static-capacity per-expert
bmm (K1 per expert for integer experts), which also trains: the
straight-through backward of the expert matmuls (or, with
``llm.int8_backward``, their int8 dx on K1) and the router's
load-balancing loss (``router_aux_loss``).

``act_quant`` is JAX's: True runs the integer projections on the kernels
above, "int8_bwd" adds the int8 dx of ``llm.int8_backward``, False is the
weight-only product ``(x @ W) * scale`` at the compute dtype
(``int8_matmul = false``). ``remat`` (``llm.remat``) recomputes the blocks
of the training forward in the backward (``remat_call``), as JAX's
call-site remat does; prefill and the cached path call them plainly.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.flash_attention import dispatch_attention, rope_flash_attention
from ...ops.kernels.grouped_matmul import (gmm, gmm_metadata, gmm_visits, pick_block_n,
                                            row_quant)
from ...ops.kernels.rope_attention import MAX_KEYS, rope, rope_attention, rope_tables
from ...ops.kernels.w4a8 import (act_quant_w4a8_matmul, dequant_codebook, pad_packed,
                                 unpack4_split)
from ...ops.kernels.w8a8 import (K_ALIGN, act_quant_matmul, int8_gemm, kn_weight, pad_cols,
                                 quantize_grad_rows, quantize_rows, unit_scale)
from .config import DecoderConfig, LoraSpec


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


class DerivedWeights(nn.Module):
    """A module whose frozen integer weights have copies in another layout
    for the kernels (``derived``): each made at its first use, kept as a
    non-persistent buffer (not in ``state_dict``, not in a checkpoint) and
    refilled in place when ``load_state_dict`` replaces the weights, so a
    captured step that reads it stays valid."""

    def __init__(self):
        super().__init__()
        self._derivers = {}

    def derived(self, name: str, make) -> torch.Tensor:
        t = self._buffers.get(name)
        if t is None:
            # a normal tensor, made outside any autograd graph, even when first
            # asked for in a serving step under inference mode
            with torch.inference_mode(False), torch.no_grad():
                t = make()
            self.register_buffer(name, t, persistent=False)
            self._derivers[name] = make
        return t

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        with torch.no_grad():
            for name, make in self._derivers.items():
                self._buffers[name].copy_(make())


class QuantLinear(DerivedWeights):
    """Quantized projection (JAX QuantDense): per-channel scale [N], the
    weight transposed from the JAX kernel_q.

    bits=8: int8 weight [N, K]; w8a8 (K1), activations quantized per row.
    bits=4: split-halves packed int4 [N, ceil(K/2)], three routes as in
    ``QuantDense.__call__``: the absmax codebook with K even runs K1's
    quantizer and K5; with K odd, the unpacked weight on K1; the bnb
    codebooks ("nf4", "fp4") a table dequant and ``(x @ w) * scale`` at the
    compute dtype (weight-only, as JAX's XLA dot). ``act_quant`` False
    (``int8_matmul = false``) makes the integer weights weight-only too:
    ``(x @ W) * scale`` at the compute dtype. The f32 product is rounded to
    ``dtype`` (the input's dtype when None), as JAX casts the f32 result.

    The gradient reaches x through the straight-through backward of
    ``_act_quant_matmul`` (at 4 bits the weight unpacked first); with
    ``act_quant = "int8_bwd"`` through the int8 dx on the weight's ``[K,
    N]`` copy (``weight_kn()``, the buffer ``kn_copy``, made at the first such
    backward). The
    codebook and weight-only products differentiate as plain matmuls. On a
    card a contraction width off the GEMMs' 16-byte rows gets a padded copy
    of the weight (the buffer ``pad_copy``), made once."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype | None = None,
                 bits: int = 8, codebook: str = "absmax", bias: bool = False,
                 act_quant: bool | str = True):
        super().__init__()
        self.dtype, self.d_in, self.bits = dtype, d_in, bits
        self.codebook = codebook if bits == 4 else "absmax"
        self.act_quant = act_quant
        cols = d_in if bits == 8 else (d_in + 1) // 2
        self.register_buffer("weight_q", torch.zeros(d_out, cols, dtype=torch.int8))
        self.scale = nn.Parameter(torch.ones(d_out), requires_grad=False)
        # the ln family's bias (QuantDense's use_bias), added at the compute
        # dtype after the GEMM's rescale, as JAX adds it
        self.bias = nn.Parameter(torch.zeros(d_out), requires_grad=False) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._product(x)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def _int8_weight(self) -> torch.Tensor:
        """The weight as int8 [N, K] (unpacked at 4 bits)."""
        return self.weight_q if self.bits == 8 else unpack4_split(self.weight_q, self.d_in)

    def weight_kn(self) -> torch.Tensor:
        """The int8 dx's ``[K, N]`` copy of the weight (``kn_weight``)."""
        return self.derived("kn_copy", lambda: kn_weight(self._int8_weight()))

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or x.dtype
        if self.codebook != "absmax":
            w = dequant_codebook(self.weight_q, self.d_in, self.codebook).to(cd)
            return (x.to(cd) @ w.T) * self.scale.to(cd)
        if not self.act_quant:
            return (x.to(cd) @ self._int8_weight().to(cd).T) * self.scale.to(cd)
        w_kn = self.weight_kn if self.act_quant == "int8_bwd" else None
        padded = self.weight_q.is_cuda
        if self.bits == 4 and not self.d_in % 2:
            w = self.weight_q
            if padded and (self.d_in // 2) % K_ALIGN:
                w = self.derived("pad_copy", lambda: pad_packed(self.weight_q, self.d_in))
            return act_quant_w4a8_matmul(x, w, self.scale, cd, w_kn)
        if self.bits == 8:
            w = self.weight_q
            if padded and self.d_in % K_ALIGN:
                w = self.derived("pad_copy", lambda: pad_cols(self.weight_q))
        else:  # odd K at 4 bits: the unpacked weight on K1
            w = self._int8_weight()
            w = pad_cols(w) if padded else w
        return act_quant_matmul(x, w, self.scale, cd, w_kn)


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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6 unless given, parameters ``scale`` and
    ``bias``): the statistics in f32 as E[x^2] - E[x]^2 clipped at 0, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, emitted at ``dtype``
    when given, else at the promoted type of the input and the parameters."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(-1, keepdim=True) - mean.square(), 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale.float()) + self.bias.float()
        return y.to(self.dtype or torch.promote_types(x.dtype, self.scale.dtype))


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p and
    scale it by 1 / (1 - p); the mask is drawn from ``generator`` (on x's
    device), so a seeded trainer repeats its masks, or taken from a
    ``MaskTape`` (a remat'd block's)."""
    if p == 0.0:
        return x
    if isinstance(generator, MaskTape):
        keep = generator.keep(x.shape, p, x.device)
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class MaskTape:
    """The dropout masks of one remat'd block call. Its forward draws them
    from ``generator`` as the plain call would, in the same order, and
    keeps them (one byte an element); the recompute in the backward replays
    them, so it drops exactly what the forward dropped and the generator is
    read once, as without remat. (``torch.utils.checkpoint``'s
    ``preserve_rng_state`` restores the default generators only; this is the
    same guarantee for the explicit one, and it holds inside a CUDA graph
    capture, where the generator's state cannot be read back.)"""

    def __init__(self, generator: torch.Generator | None):
        self.generator, self.masks, self.pos = generator, [], None

    def start(self) -> None:
        """Called at the top of every run of the block: the first records,
        each later one replays from the first mask."""
        self.pos = None if self.pos is None and not self.masks else 0

    def keep(self, shape, p: float, device) -> torch.Tensor:
        if self.pos is None:
            keep = torch.rand(shape, generator=self.generator, device=device) < 1.0 - p
            self.masks.append(keep)
            return keep
        keep = self.masks[self.pos]
        self.pos += 1
        return keep


# the matmuls whose outputs remat "dots" keeps: the projections (mm, addmm and
# the integer GEMMs of K1 and K5); a MoE block also keeps the batched ones, as
# JAX's dots_saveable does for its expert matmuls
_DOTS = ("aten.mm.default", "aten.addmm.default", "medtsllm.w8a8_gemm.default",
         "medtsllm.w4a8_gemm.default")
_BATCHED_DOTS = ("aten.bmm.default", "aten.baddbmm.default")


def _dots_policy(moe: bool):
    """JAX's ``_dots_policy``: dense blocks save the non-batched matmuls
    (``dots_with_no_batch_dims_saveable``: the attention scores recompute),
    MoE blocks every matmul (``dots_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy
    saved = set(_DOTS + (_BATCHED_DOTS if moe else ()))

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if str(op) in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat_call(fn, x: torch.Tensor, generator, remat, moe: bool = False) -> torch.Tensor:
    """``fn(x, generator)`` (a block) under JAX's remat policy
    (``_remat_block_call``): nothing kept but x, the block recomputed in the
    backward (True / "full"), or its matmul outputs kept and the rest
    recomputed ("dots", ``_dots_policy``). Non-reentrant
    ``torch.utils.checkpoint``; the dropout masks through a ``MaskTape``."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    tape = MaskTape(generator)

    def run(h):
        tape.start()
        return fn(h, tape)
    kwargs = {}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy(moe))
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False, **kwargs)


def projection(d_in: int, d_out: int, quantize: int, dtype,
               codebook: str = "absmax", bias: bool = False,
               act_quant: bool | str = True) -> nn.Module:
    if quantize:
        return QuantLinear(d_in, d_out, dtype, quantize, codebook, bias, act_quant)
    return Linear(d_in, d_out, bias=bias, dtype=dtype)


class LoRALinear(nn.Module):
    """A projection with a low-rank adapter (JAX ``LoRADense``): ``base(x)
    + scaling * (x A) B``, ``base`` a ``Linear`` or ``QuantLinear`` (under
    ``base``, as in the flax tree), ``lora_a`` [d_in, rank] and ``lora_b``
    [rank, d_out] in JAX's layout, the delta at x's dtype. In train mode x
    first goes through the adapter's dropout (``spec.dropout``, masks from
    ``generator``). ``out_mask`` [d_out] (0 / 1) restricts the adapter to
    the targeted thirds of gpt2's fused ``c_attn``: masked columns of
    ``lora_b`` get a zero delta and a zero gradient."""

    def __init__(self, base: nn.Module, d_in: int, d_out: int, spec: LoraSpec,
                 out_mask: torch.Tensor | None = None):
        super().__init__()
        self.base, self.spec = base, spec
        self.lora_a = nn.Parameter(torch.zeros(d_in, spec.rank))
        self.lora_b = nn.Parameter(torch.zeros(spec.rank, d_out))
        self.register_buffer("lora_out_mask", out_mask, persistent=False)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        y = self.base(x)
        xd = dropout(x, self.spec.dropout, generator) if self.training else x
        delta = (xd @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * self.spec.scaling
        if self.lora_out_mask is not None:
            delta = delta * self.lora_out_mask.to(delta.dtype)
        return y + delta


def _project(module: nn.Module, x: torch.Tensor, generator):
    return module(x, generator) if isinstance(module, LoRALinear) else module(x)


# the ln family's MLP activations (HF's activation_function / hidden_act
# names, transformer.py:672-690 of the JAX package)
def _gelu_tanh(v):
    return F.gelu(v, approximate="tanh")


ACTS = {"gelu_tanh": _gelu_tanh, "gelu_new": _gelu_tanh, "gelu_fast": _gelu_tanh,
        "gelu_pytorch_tanh": _gelu_tanh, "quick_gelu": lambda v: v * torch.sigmoid(1.702 * v),
        "gelu": F.gelu, "relu": F.relu, "silu": F.silu, "swish": F.silu}


def ln_activation(cfg: DecoderConfig):
    """The ln family's MLP activation: gpt2's tanh GELU always; else the
    config's ``act_fn`` or the style's own (opt relu, neox exact GELU)."""
    act = "gelu_tanh" if cfg.style == "gpt2" else (
        cfg.act_fn or {"opt": "relu", "neox": "gelu"}[cfg.style])
    if act not in ACTS:
        raise NotImplementedError(f"hidden activation {act!r} (from the snapshot's "
                                  "activation_function/hidden_act) is not mapped; known: "
                                  f"{sorted(ACTS)}")
    return ACTS[act]


class Attention(nn.Module):
    """Attention of each style (``Attention`` of the JAX package): llama's
    and t5's bias-free ``q/k/v/o_proj``; gpt2's fused biased ``c_attn``
    split q | k | v and its biased ``c_proj``; opt's, neox's and bart's
    biased ``q/k/v/o_proj``. ``cross`` makes it the encoder-decoders'
    cross-attention: q from x, k / v from the encoder's output ``kv`` (S
    rows), no rotation, never causal; gpt2's then takes ``q/k/v_proj`` and
    ``c_proj``, as JAX builds the fused ``c_attn`` only for self-attention.
    ``causal`` False is the encoders' self-attention. Projections are
    quantized at ``quantize`` 8 or 4, and those ``lora`` targets carry
    adapters (``LoRALinear``; gpt2's fused ``c_attn`` when any of q / k / v
    is a target, masked to the targeted thirds). The output projection is
    followed by the residual dropout (``cfg.dropout``, train mode). No
    attention-probability dropout: JAX leaves it out on purpose (the kernel
    never holds the probabilities), although HF gpt2 has it.

    ``cfg.fused_projections`` (llama self-attention) builds one ``qkv_proj``
    [H*D | KV*D | KV*D] in place of q / k / v (JAX's ``transformer.py:537-
    556``); LoRA then adapts it once when any of q / k / v is a target,
    masked to the targeted slices as gpt2's ``c_attn``. q, k and v are column
    views of its output: K2 reads them in place (row-pitched operands), the
    K4 route takes dense copies."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None,
                 lora: LoraSpec | None = None, act_quant: bool | str = True,
                 causal: bool = True, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.causal, self.cross = causal and not cross, cross
        H, KV, D, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
        cb, bias = cfg.quant4_codebook, cfg.ln_family
        self.fused = cfg.fused_projections and cfg.style == "llama" and not cross
        self.qkv_sizes = (H * D, KV * D, KV * D)

        def proj(d_in, d_out, key, mask=None):
            base = projection(d_in, d_out, quantize, dtype, cb, bias, act_quant)
            if lora is None or key not in lora.targets:
                return base
            return LoRALinear(base, d_in, d_out, lora, mask)

        if cfg.style == "gpt2" and not cross:
            targeted = tuple(t for t in ("q", "k", "v") if lora and t in lora.targets)
            mask = None
            if targeted and targeted != ("q", "k", "v"):
                mask = torch.tensor([float(t in targeted) for t in ("q", "k", "v")]
                                    ).repeat_interleave(d)
            self.c_attn = proj(d, 3 * d, targeted[0] if targeted else "q", mask)
        elif self.fused:
            sizes = self.qkv_sizes
            targeted = tuple(t for t in ("q", "k", "v") if lora and t in lora.targets)
            mask = None
            if targeted and targeted != ("q", "k", "v"):
                mask = torch.cat([torch.full((n,), float(t in targeted))
                                  for t, n in zip(("q", "k", "v"), sizes)])
            self.qkv_proj = proj(d, sum(sizes), targeted[0] if targeted else "q", mask)
        else:
            self.q_proj = proj(d, H * D, "q")
            self.k_proj = proj(d, KV * D, "k")
            self.v_proj = proj(d, KV * D, "v")
        if cfg.style == "gpt2":
            self.c_proj = proj(H * D, d, "o")
        else:
            self.o_proj = proj(H * D, d, "o")

    def forward(self, x, prefix_kv=None, position_offset: int = 0,
                return_kv: bool = False, generator: torch.Generator | None = None, *,
                kv=None, attn_bias=None):
        """x [B, L, d]; ``kv`` [B, S, d] the encoder's output (cross);
        ``attn_bias`` [1, H, L, S] t5's relative-position bias (scores
        unscaled: t5 folds 1/sqrt(D) into its init). ``prefix_kv`` = (k, v)
        each [1 or B, KV, P, D], already rotated at positions 0..P-1, with x
        at positions P.. (pass ``position_offset=P``). ``return_kv`` also
        returns this call's rotated (k, v) [B, KV, L, D], the prefill cache.

        The route: causal llama self-attention at head dim 64 or 128 with no
        bias takes K2 when the call has at most ``K4_MIN_KEYS - 1`` keys and
        at most K2's ``MAX_KEYS``, else K4's route (``rope_flash_attention``,
        ``transformer.py:591-633`` of the JAX package); K4 has no backward,
        so a call that needs a gradient keeps K2 and raises past its key
        limit. Every other call (the ln family, t5, llama at other head
        dims, every encoder and every cross-attention) takes JAX's default
        path: the rotation (llama and neox self-attention; neox on its
        leading ``rotary_dims``), the head transpose, the prefix ahead of k /
        v, then ``dispatch_attention`` (the plain version below 512 tokens or
        with a bias, K4 from there where JAX's gate sends it)."""
        cfg = self.cfg
        B, L, _ = x.shape
        src = x if kv is None else kv
        S = src.shape[1]
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        if cfg.style == "gpt2" and not self.cross:
            q, k, v = _project(self.c_attn, x, generator).split(cfg.d_model, dim=-1)
        elif self.fused:
            q, k, v = _project(self.qkv_proj, x, generator).split(self.qkv_sizes, dim=-1)
        else:
            q = _project(self.q_proj, x, generator)
            k, v = (_project(p, src, generator) for p in (self.k_proj, self.v_proj))
        if self.dtype is not None:  # cast before the head split, as JAX does
            q, k, v = q.to(self.dtype), k.to(self.dtype), v.to(self.dtype)
        q = q.reshape(B, L, H, D)
        k = k.reshape(B, S, KV, D)
        v = v.reshape(B, S, KV, D)
        pk, pv = prefix_kv if prefix_kv is not None else (None, None)
        if cfg.style == "llama" and D in (64, 128) and self.causal and attn_bias is None:
            out, new_kv = self._llama_kernels(q, k, v, pk, pv, position_offset, return_kv)
        else:
            out, new_kv = self._dispatch(q, k, v, pk, pv, position_offset, return_kv, attn_bias)
        out = _project(self.o_proj if cfg.style != "gpt2" else self.c_proj,
                       out.reshape(B, L, H * D), generator)
        if self.training:
            out = dropout(out, cfg.dropout, generator)
        return (out, new_kv) if return_kv else out

    def _llama_kernels(self, q, k, v, pk, pv, position_offset, return_kv):
        """llama at D 64 / 128: K2, or K4's route -> (out [B, L, H, D], the
        rotated (k, v) [B, KV, L, D] or None)."""
        cfg = self.cfg
        L, D = q.shape[1], q.shape[3]
        positions = torch.arange(position_offset, position_offset + L, device=q.device)
        cos, sin = rope_tables(positions, D, cfg.rope_theta)
        keys = L + (pk.shape[2] if pk is not None else 0)
        sm_scale = 1.0 / math.sqrt(D)
        needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        if needs_grad and keys > MAX_KEYS:
            raise NotImplementedError(
                f"training through attention over {keys} keys needs a backward of the "
                "flash-attention kernel, which the JAX package does not have (ROADMAP "
                "queue 1, \"Training on the served backbones\")")
        if not needs_grad and (keys > MAX_KEYS or keys >= K4_MIN_KEYS):
            # the route reads dense operands: the fused projection's column
            # views are copied (a no-op for the separate projections' outputs)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out = rope_flash_attention(q, k, v, cos, sin, pk, pv, sm_scale, return_kv)
            return out if return_kv else (out, None)
        out = rope_attention(q, k, v, cos, sin, pk, pv, sm_scale)
        if not return_kv:
            return out, None
        return out, (rope(k, cos, sin).transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous())

    def _dispatch(self, q, k, v, pk, pv, position_offset, return_kv, bias=None):
        """JAX's default path (``transformer.py:591-633``) -> (out [B, L, H,
        D], the rotated (k, v) [B, KV, L, D] or None)."""
        cfg = self.cfg
        B, L, D = q.shape[0], q.shape[1], q.shape[3]
        if cfg.style in ("llama", "neox") and not self.cross:
            rot = cfg.rotary_dims
            positions = torch.arange(position_offset, position_offset + L, device=q.device)
            cos, sin = rope_tables(positions, rot, cfg.rope_theta)

            def rotate(t):
                if rot == D:
                    return rope(t, cos, sin)
                return torch.cat([rope(t[..., :rot], cos, sin), t[..., rot:]], dim=-1)
            q, k = rotate(q), rotate(k)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        new_kv = (k.contiguous(), v.contiguous()) if return_kv else None
        if pk is not None:
            k = torch.cat([pk.to(k.dtype).expand(B, -1, -1, -1), k], dim=2)
            v = torch.cat([pv.to(v.dtype).expand(B, -1, -1, -1), v], dim=2)
        out = dispatch_attention(q, k, v, causal=self.causal,
                                 sm_scale=1.0 if cfg.style == "t5" else None, bias=bias)
        return out.transpose(1, 2), new_kv


class MLP(nn.Module):
    """llama's SwiGLU (``gate_proj``, ``up_proj``, ``down_proj``, no bias;
    under ``cfg.fused_projections`` one ``gateup_proj`` [gate | up], split in
    half, JAX's ``transformer.py:707-709``);
    the ln family's biased ``c_fc`` -> activation (``ln_activation``) ->
    ``c_proj`` -> the residual dropout (train mode); t5's bias-free ``wi``
    -> relu, or gated (``t5_gated``) tanh-GELU(``wi_0``) x ``wi_1``, then the
    dropout (train mode), then ``wo``."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None,
                 act_quant: bool | str = True):
        super().__init__()
        cb = cfg.quant4_codebook
        self.ln, self.t5 = cfg.ln_family, cfg.style == "t5"
        if self.t5:
            self.p, self.gated = cfg.dropout, cfg.t5_gated
            names = ("wi_0", "wi_1") if self.gated else ("wi",)
            for name in names:
                setattr(self, name, projection(cfg.d_model, cfg.d_ff, quantize, dtype, cb,
                                               act_quant=act_quant))
            self.wo = projection(cfg.d_ff, cfg.d_model, quantize, dtype, cb, act_quant=act_quant)
            return
        if self.ln:
            self.p, self.act = cfg.dropout, ln_activation(cfg)
            self.c_fc = projection(cfg.d_model, cfg.d_ff, quantize, dtype, cb, True, act_quant)
            self.c_proj = projection(cfg.d_ff, cfg.d_model, quantize, dtype, cb, True,
                                     act_quant)
            return
        self.fused = cfg.fused_projections
        if self.fused:
            self.gateup_proj = projection(cfg.d_model, 2 * cfg.d_ff, quantize, dtype, cb,
                                          act_quant=act_quant)
        else:
            self.gate_proj = projection(cfg.d_model, cfg.d_ff, quantize, dtype, cb,
                                        act_quant=act_quant)
            self.up_proj = projection(cfg.d_model, cfg.d_ff, quantize, dtype, cb,
                                      act_quant=act_quant)
        self.down_proj = projection(cfg.d_ff, cfg.d_model, quantize, dtype, cb,
                                    act_quant=act_quant)

    def forward(self, x, generator=None):
        if self.t5:
            h = (_gelu_tanh(self.wi_0(x)) * self.wi_1(x) if self.gated
                 else F.relu(self.wi(x)))
            return self.wo(dropout(h, self.p, generator) if self.training else h)
        if not self.ln:
            if self.fused:
                gate, up = self.gateup_proj(x).chunk(2, dim=-1)
            else:
                gate, up = self.gate_proj(x), self.up_proj(x)
            return self.down_proj(F.silu(gate) * up)
        h = self.c_proj(self.act(self.c_fc(x)))
        return dropout(h, self.p, generator) if self.training else h


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    """Static per-expert slot count. factor <= 0 means dropless: top_k
    gives each token at most one slot per expert, so capacity = n_tokens
    is exact. Positive factors give the GShard bound ceil(k*T/E * f),
    rounded up to a multiple of 8, capped at T."""
    if factor <= 0:
        return n_tokens
    cap = math.ceil(top_k * n_tokens / n_experts * factor)
    return min(((cap + 7) // 8) * 8, n_tokens)


def _act_quant_bmm(h, wq, scale):
    E, C, K = h.shape
    xq, xs = quantize_rows(h.reshape(E * C, K).contiguous())
    xq, xs, ws = xq.reshape(E, C, K), xs.reshape(E, C), scale.float()
    if h.is_cuda and K % K_ALIGN:  # the GEMM's 16-byte rows: zero columns
        xq, wq = pad_cols(xq), pad_cols(wq)
    return torch.stack([int8_gemm(xq[e], wq[e], xs[e], ws[e].contiguous())
                        for e in range(E)])


def int8_dh(g: torch.Tensor, w_kn: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The batched int8 dh (``_act_quant_bmm_bwd``'s int8 branch): g [E, C,
    N], the experts' ``kn_weight`` copies [E, K, N16], scale [E, N] ->
    [E, C, K] f32: one gradient-row quantizer over the E*C rows (each
    expert's scale row), then K1's GEMM per expert."""
    E, C, N = g.shape
    K, ld = w_kn.shape[1:]
    gq, g_scale = quantize_grad_rows(g.reshape(E * C, N).contiguous(),
                                     scale.float().contiguous(), ld)
    gq, g_scale = gq.reshape(E, C, ld), g_scale.reshape(E, C)
    ones = unit_scale(K, g.device)
    return torch.stack([int8_gemm(gq[e], w_kn[e], g_scale[e], ones) for e in range(E)])


class _ActQuantBmm(torch.autograd.Function):
    """The custom_vjp of ``transformer.py::_act_quant_bmm`` of the JAX
    package: the forward is K1 (its quantizer over the E*C rows, then its
    GEMM per expert); the backward is ``_act_quant_bmm_bwd``'s
    straight-through estimator, ``dh = (g * scale) @ W_q`` per expert at
    g's dtype, the quantization taken as identity, a plain ``torch.bmm`` as
    JAX leaves it to an XLA dot (the pattern of
    ``ops/kernels/w8a8.py::_ActQuantMatmul``); or, given ``w_kn``
    (``llm.int8_backward``), ``int8_dh``. The int8 weight and its scale are
    frozen: no gradient."""

    @staticmethod
    def forward(ctx, h, wq, scale, w_kn):
        ctx.save_for_backward(wq, scale)
        ctx.h_dtype, ctx.w_kn = h.dtype, w_kn
        return _act_quant_bmm(h, wq, scale)

    @staticmethod
    def backward(ctx, g):
        wq, scale = ctx.saved_tensors
        if ctx.w_kn is not None:
            dh = int8_dh(g, ctx.w_kn(), scale)
        else:
            dh = torch.bmm(g * scale[:, None, :].to(g.dtype), wq.to(g.dtype))
        return dh.to(ctx.h_dtype), None, None, None


def act_quant_bmm(h: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                  w_kn=None) -> torch.Tensor:
    """Per-expert w8a8 matmul with per-row activation quantization
    (``transformer.py::_act_quant_bmm``): h [E, C, K] f32, wq [E, N, K]
    int8, scale [E, N] -> [E, C, N] f32 = acc * (x_scale * scale). K1's
    quantizer over the E*C rows, then K1's GEMM per expert.
    Differentiable in h when h requires grad: the straight-through
    estimator, or the int8 dh when ``w_kn`` (returning the experts'
    ``kn_weight`` copies) is given."""
    if torch.is_grad_enabled() and h.requires_grad:
        return _ActQuantBmm.apply(h, wq, scale, w_kn)
    return _act_quant_bmm(h, wq, scale)


def router_aux_loss(probs: torch.Tensor, top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The Switch / Mixtral load-balancing loss (``transformer.py::
    router_aux_loss``): E * sum_e f_e * P_e, f_e the per-token count of
    assignments to expert e (the [T, k, E] one-hot averaged over T, summed
    over k) and P_e the mean router probability on e; top_k at perfect
    balance."""
    probs = probs.reshape(-1, n_experts).float()
    experts = torch.arange(n_experts, device=probs.device)
    onehot = (top_i.reshape(-1)[:, None] == experts[None, :]).float()
    top_k = top_i.numel() // probs.shape[0]
    f = onehot.mean(0) * top_k
    return n_experts * torch.sum(f * probs.mean(0))


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


class MoEMLP(DerivedWeights):
    """Mixtral-style sparse-MoE SwiGLU FFN (``transformer.py::MoEMLP``,
    single device): router softmax in f32, top-k of the probabilities
    renormalized, rank within expert by a cumsum over the one-hot
    assignment. Experts run either as the dropless grouped chain
    (``moe_grouped`` with int8 or absmax int4 experts, in eval without a
    gradient: K6 twice) or as the static-capacity dispatch into an [E, C, d]
    buffer, slots beyond C dropped in token order (to a trash row that no
    kept value or gradient reads), then E-batched matmuls (K1 per expert for
    int8 and absmax int4 experts, the int4 unpacked first; a table dequant
    and ``torch.bmm`` for the nf4 / fp4 codebooks; ``torch.bmm`` for dense
    experts).

    Training takes the capacity path, as JAX does when not deterministic:
    the expert matmuls carry the straight-through backward
    (``act_quant_bmm``) and the router's gradient flows through the
    renormalized top-k weights. In train mode each call records its
    ``router_aux_loss`` in ``router_aux`` (JAX sows it per layer), which the
    train step adds when ``training.router_aux_coef`` is set; in eval it is
    None.

    Parameters: ``gate`` [D, E]; int8 experts ``w_{gate,up,down}_q``
    [E, N, K] (the kernels' layout, the transpose of JAX's [E, K, N]) or
    packed int4 [E, N, ceil(K/2)], with scales [E, N]; dense experts
    ``w_{gate,up,down}`` [E, K, N] (JAX's layout)."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None,
                 act_quant: bool | str = True):
        super().__init__()
        self.cfg, self.quantize, self.dtype = cfg, quantize, dtype
        self.act_quant = act_quant
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
        self.router_aux = None

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
        d_in = h.shape[-1]
        if self.quantize == 4:
            cb = self.cfg.quant4_codebook
            if cb != "absmax":  # the table dequant, a bmm at the compute dtype
                w = dequant_codebook(wq, d_in, cb).to(h.dtype)
                return torch.bmm(h, w.transpose(1, 2)) * scale[:, None, :].to(h.dtype)
            wq = unpack4_split(wq, d_in)
        if not self.act_quant:  # weight-only: (h @ W) * scale at the compute dtype
            return torch.bmm(h, wq.transpose(1, 2).to(h.dtype)) * scale[:, None, :].to(h.dtype)
        w_kn = None
        if self.act_quant == "int8_bwd":
            w_kn = functools.partial(self.derived, name + "_kn",
                                     functools.partial(self._kn, name, d_in))
        return act_quant_bmm(h.float(), wq, scale, w_kn).to(h.dtype)

    def _kn(self, name: str, d_in: int) -> torch.Tensor:
        """The experts' ``[E, K, N16]`` copies for the int8 dh."""
        wq = getattr(self, name + "_q")
        return kn_weight(unpack4_split(wq, d_in) if self.quantize == 4 else wq)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the MLPs' interface (the experts have no dropout)."""
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
        self.router_aux = router_aux_loss(probs, top_i, E) if self.training else None
        eid = top_i.reshape(T * k)
        # rank of each slot within its expert: a running count over the slots,
        # taken along the inner axis of an [E, T*k] one-hot (a cumsum over the
        # outer axis of [T*k, E] is a slow kernel on the card)
        onehot = (eid[None, :] == torch.arange(E, device=x.device)[:, None]).to(torch.int32)
        pos = ((torch.cumsum(onehot, 1, dtype=torch.int32) - onehot) * onehot).sum(0)
        src = torch.arange(T, device=x.device).repeat_interleave(k)

        int_experts = self.quantize == 8 or (self.quantize == 4
                                             and cfg.quant4_codebook == "absmax")
        # K6 has no backward: a call that needs a gradient takes the capacity
        # path, as does training
        needs_grad = torch.is_grad_enabled() and x.requires_grad
        if cfg.moe_grouped and int_experts and self.act_quant and not (
                self.training or needs_grad):
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
    """A block: RMSNorm ``input_layernorm`` / ``post_attention_layernorm``
    (llama, t5) or LayerNorm ``ln_1`` / ``ln_2`` at ``cfg.norm_eps`` (the ln
    family); pre-norm ``x + attn(n1(x))``, then ``x + mlp(n2(x))``, or
    neox's parallel residual ``x + attn(ln_1(x)) + mlp(ln_2(x))``, or bart's
    post-norm ``n1(x + attn(x))``, ``n2(x + mlp(x))``. ``cross`` (the
    encoder-decoders' decoder) adds the cross-attention sublayer into
    ``enc_out`` between the two, with its norm ``ln_cross`` /
    ``cross_attention_layernorm`` in the same order; ``causal`` False is an
    encoder's block. The FFN is the MoE one when the config has more than
    one expert."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None,
                 lora: LoraSpec | None = None, act_quant: bool | str = True,
                 causal: bool = True, cross: bool = False):
        super().__init__()
        self.cfg, self.cross = cfg, cross
        if cfg.ln_family:
            self.n1, self.n2, self.nc = "ln_1", "ln_2", "ln_cross"
            norm = lambda: LayerNorm(cfg.d_model, cfg.norm_eps, dtype)  # noqa: E731
        else:
            self.n1, self.n2 = "input_layernorm", "post_attention_layernorm"
            self.nc = "cross_attention_layernorm"
            norm = lambda: RMSNorm(cfg.d_model, cfg.norm_eps)  # noqa: E731
        setattr(self, self.n1, norm())
        self.attn = Attention(cfg, quantize, dtype, lora, act_quant, causal)
        if cross:
            setattr(self, self.nc, norm())
            self.cross_attn = Attention(cfg, quantize, dtype, lora, act_quant, cross=True)
        setattr(self, self.n2, norm())
        self.mlp = (MoEMLP if cfg.n_experts > 1 else MLP)(cfg, quantize, dtype, act_quant)

    def forward(self, x, prefix_kv=None, position_offset: int = 0,
                return_kv: bool = False, generator: torch.Generator | None = None, *,
                enc_out=None, attn_bias=None):
        post = self.cfg.post_ln
        n1, n2 = getattr(self, self.n1), getattr(self, self.n2)
        a = self.attn(x if post else n1(x), prefix_kv, position_offset, return_kv, generator,
                      attn_bias=attn_bias)
        new_kv = None
        if return_kv:
            a, new_kv = a
        if self.cfg.parallel_residual:
            x = x + a + self.mlp(n2(x), generator)
            return (x, new_kv) if return_kv else x
        x = x + a
        if post:
            x = n1(x)
        if self.cross:
            nc = getattr(self, self.nc)
            x = x + self.cross_attn(x if post else nc(x), generator=generator, kv=enc_out)
            if post:
                x = nc(x)
        x = x + self.mlp(x if post else n2(x), generator)
        if post:
            x = n2(x)
        return (x, new_kv) if return_kv else x


class TransformerDecoder(nn.Module):
    """Returns the last hidden state (no LM head), like HF ``AutoModel``.

    llama: RMSNorm blocks with rotary attention and the final ``norm``. The
    ln family (gpt2, opt, neox): learned positions ``wpe`` (gpt2; opt's with
    ``pos_offset`` 2 more rows, read from row 2), the embedding dropout, the
    pre-LN blocks and the final ``ln_f``. Every style serves a prompt-prefix
    cache (``prefill`` -> ``prefix_kv``: the suffix then sits at positions
    P.., its learned positions read from row P + ``pos_offset``). Dropout
    (``cfg.dropout``; LoRA's own) acts in train mode from ``generator``.
    ``lora`` puts adapters on its target projections (``LoRALinear``).
    ``remat`` (False, True / "full" or "dots") recomputes each block in the
    backward of a forward with no prefix that needs gradients
    (``remat_call``), as JAX's decoder does at its call site; the cached
    path and the prefill call the blocks plainly."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None,
                 lora: LoraSpec | None = None, act_quant: bool | str = True,
                 remat: bool | str = False):
        super().__init__()
        if cfg.style not in ("llama", "gpt2", "opt", "neox") or cfg.is_encoder_decoder:
            raise ValueError(f"TransformerDecoder builds the decoder-only styles; "
                             f"{cfg.style!r} (encoder-decoder: {cfg.is_encoder_decoder}) is "
                             "TransformerEncDec's")
        self.cfg, self.remat = cfg, remat
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model),
                                requires_grad=False)
        if cfg.learned_positions:
            self.wpe = nn.Parameter(torch.zeros(cfg.max_position + cfg.pos_offset,
                                                cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg, quantize, dtype, lora, act_quant)
                                    for _ in range(cfg.n_layers))
        if cfg.ln_family:
            self.ln_f = LayerNorm(cfg.d_model, cfg.norm_eps, dtype)
        else:
            self.norm = RMSNorm(cfg.d_model, cfg.norm_eps)

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.wte[token_ids]

    def _positions(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """x plus its learned positions from row ``offset + pos_offset``."""
        if not self.cfg.learned_positions:
            return x
        p0 = offset + self.cfg.pos_offset
        return x + self.wpe[None, p0:p0 + x.shape[1]].to(x.dtype)

    def forward(self, inputs_embeds: torch.Tensor, prefix_kv=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``prefix_kv``: per-layer (k, v) from ``prefill``; inputs_embeds
        is then the suffix at positions P..; ``generator`` draws the dropout
        masks in train mode."""
        offset = prefix_kv[0][0].shape[2] if prefix_kv is not None else 0
        x = self._positions(inputs_embeds, offset)
        if self.cfg.ln_family and self.training:
            x = dropout(x, self.cfg.dropout, generator)
        if self.remat and prefix_kv is None and torch.is_grad_enabled():
            moe = self.cfg.n_experts > 1
            for block in self.blocks:
                x = remat_call(lambda h, g, b=block: b(h, generator=g), x, generator,
                               self.remat, moe)
        else:
            for i, block in enumerate(self.blocks):
                x = block(x, None if prefix_kv is None else prefix_kv[i], offset,
                          generator=generator)
        return self.ln_f(x) if self.cfg.ln_family else self.norm(x)

    def prefill(self, inputs_embeds: torch.Tensor) -> tuple:
        """Per-layer rotated (k, v) of a prompt prefix [1 or N, P, d] at
        positions 0..P-1 (no dropout: the cache is computed
        deterministically)."""
        x = self._positions(inputs_embeds, 0)
        kvs = []
        for block in self.blocks:
            x, kv = block(x, return_kv=True)
            kvs.append(kv)
        return tuple(kvs)


def t5_relative_buckets(L: int, S: int, *, bidirectional: bool, num_buckets: int,
                        max_distance: int, device=None) -> torch.Tensor:
    """t5's relative-position bucket ids [L, S] (``t5_relative_buckets`` of
    the JAX package, HF's ``_relative_position_bucket``): key minus query
    position; exact buckets below half the (per-sign, when bidirectional)
    count, log-spaced ones up to ``max_distance``, the last bucket past it."""
    ctx = torch.arange(L, dtype=torch.int32, device=device)[:, None]
    mem = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    rel = mem - ctx
    if bidirectional:
        nb = num_buckets // 2
        base = (rel > 0).to(torch.int32) * nb
        n = rel.abs()
    else:
        nb = num_buckets
        base = torch.zeros_like(rel)
        n = torch.clamp_min(-rel, 0)
    max_exact = nb // 2
    large = max_exact + (torch.log(torch.clamp_min(n, 1).float() / max_exact)
                         / math.log(max_distance / max_exact) * (nb - max_exact)
                         ).to(torch.int32)
    large = torch.clamp_max(large, nb - 1)
    return base + torch.where(n < max_exact, n, large)


class TransformerEncDec(nn.Module):
    """The encoder-decoder backbone (``TransformerEncDec`` of the JAX
    package): the encoder reads ``inputs_embeds`` (MedTsLLM's prompt), the
    decoder ``decoder_inputs_embeds`` (the series' patches) with
    cross-attention into the encoder's output, and the decoder's last hidden
    state is returned (no LM head).

    t5: RMSNorm blocks, unscaled attention with the relative-position bias
    computed once a side from its table (``enc_rel_bias`` / ``dec_rel_bias``
    [buckets, heads], HF's block-0 tables) and shared by every block, relu or
    gated-gelu FFN, the final ``enc_norm`` / ``dec_norm``. bart: post-LN
    blocks, learned positions ``enc_wpe`` / ``dec_wpe`` read from row
    ``pos_offset`` 2, ``enc_ln_emb`` / ``dec_ln_emb`` after them, then the
    embedding dropout (train mode), no final norm. llama (``encdec-tiny``):
    pre-norm RMSNorm blocks, rotary self-attention (the encoder's non-causal
    through the dispatcher, never K2), ``enc_norm`` / ``dec_norm``. gpt2:
    learned positions ``wpe`` on both sides, ``enc_ln_f`` / ``dec_ln_f``.
    ``embed`` scales the token embeddings by sqrt(d_model) under
    ``scale_embedding`` (the ids path only). ``remat`` recomputes every block
    of a forward that needs gradients (``remat_call``); ``lora``,
    ``quantize`` and ``act_quant`` are the decoder's."""

    def __init__(self, cfg: DecoderConfig, quantize: int = 0, dtype=None,
                 lora: LoraSpec | None = None, act_quant: bool | str = True,
                 remat: bool | str = False):
        super().__init__()
        if cfg.style not in ("llama", "gpt2", "t5", "bart") or cfg.n_experts > 1:
            raise ValueError(f"encoder-decoder style {cfg.style!r} (experts "
                             f"{cfg.n_experts}) is not one of llama, gpt2, t5, bart")
        self.cfg, self.remat = cfg, remat
        d = cfg.d_model
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, d), requires_grad=False)
        kw = dict(quantize=quantize, dtype=dtype, lora=lora, act_quant=act_quant)
        self.enc_blocks = nn.ModuleList(Block(cfg, causal=False, **kw)
                                        for _ in range(cfg.n_layers))
        self.dec_blocks = nn.ModuleList(Block(cfg, cross=True, **kw)
                                        for _ in range(cfg.n_dec_layers or cfg.n_layers))
        if cfg.style == "bart":
            rows = cfg.max_position + cfg.pos_offset
            self.enc_wpe = nn.Parameter(torch.zeros(rows, d))
            self.dec_wpe = nn.Parameter(torch.zeros(rows, d))
            self.enc_ln_emb = LayerNorm(d, cfg.norm_eps, dtype)
            self.dec_ln_emb = LayerNorm(d, cfg.norm_eps, dtype)
        elif cfg.style == "gpt2":
            self.enc_ln_f = LayerNorm(d, cfg.norm_eps, dtype)
            self.dec_ln_f = LayerNorm(d, cfg.norm_eps, dtype)
            self.wpe = nn.Parameter(torch.zeros(cfg.max_position, d))
        else:
            self.enc_norm = RMSNorm(d, cfg.norm_eps)
            self.dec_norm = RMSNorm(d, cfg.norm_eps)
        if cfg.style == "t5":
            self.enc_rel_bias = nn.Parameter(torch.zeros(cfg.rel_buckets, cfg.n_heads))
            self.dec_rel_bias = nn.Parameter(torch.zeros(cfg.rel_buckets, cfg.n_heads))

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        e = self.wte[token_ids]
        return e * math.sqrt(self.cfg.d_model) if self.cfg.scale_embedding else e

    def _rel_bias(self, table: torch.Tensor, L: int, bidirectional: bool, dtype):
        cfg = self.cfg
        buckets = t5_relative_buckets(L, L, bidirectional=bidirectional,
                                      num_buckets=cfg.rel_buckets,
                                      max_distance=cfg.rel_max_distance, device=table.device)
        return table[buckets].permute(2, 0, 1)[None].to(dtype)  # [1, H, L, L]

    def _side(self, x: torch.Tensor, side: str, generator) -> torch.Tensor:
        """One side's embeddings: the learned positions (and bart's
        LayerNorm and dropout)."""
        cfg = self.cfg
        if cfg.style == "gpt2":
            return x + self.wpe[None, :x.shape[1]].to(x.dtype)
        if cfg.style != "bart":
            return x
        p0 = cfg.pos_offset
        x = x + getattr(self, f"{side}_wpe")[None, p0:p0 + x.shape[1]].to(x.dtype)
        x = getattr(self, f"{side}_ln_emb")(x)
        return dropout(x, cfg.dropout, generator) if self.training else x

    def _stack(self, blocks, x, generator, **kw) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            for block in blocks:
                x = remat_call(lambda h, g, b=block: b(h, generator=g, **kw), x, generator,
                               self.remat)
            return x
        for block in blocks:
            x = block(x, generator=generator, **kw)
        return x

    def forward(self, inputs_embeds: torch.Tensor, decoder_inputs_embeds: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        t5 = cfg.style == "t5"
        enc = self._side(inputs_embeds, "enc", generator)
        bias = self._rel_bias(self.enc_rel_bias, enc.shape[1], True, enc.dtype) if t5 else None
        enc = self._stack(self.enc_blocks, enc, generator, attn_bias=bias)
        if cfg.style == "gpt2":
            enc = self.enc_ln_f(enc)
        elif cfg.style != "bart":  # bart's post-LN blocks end with their own norm
            enc = self.enc_norm(enc)
        dec = self._side(decoder_inputs_embeds, "dec", generator)
        bias = self._rel_bias(self.dec_rel_bias, dec.shape[1], False, dec.dtype) if t5 else None
        dec = self._stack(self.dec_blocks, dec, generator, enc_out=enc, attn_bias=bias)
        if cfg.style == "gpt2":
            return self.dec_ln_f(dec)
        return dec if cfg.style == "bart" else self.dec_norm(dec)
