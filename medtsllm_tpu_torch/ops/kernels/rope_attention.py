"""K2: fused RoPE + cached-prefix + causal attention
(``csrc/rope_attention.cu``) and its plain version.

Replaces ``medtsllm_tpu/ops/pallas/rope_attention.py::fused_rope_attention``
(forward): q/k/v in the projection layout [B, L, H|KV, D], half-split RoPE
from f32 cos/sin tables [L, D/2] cast to the compute dtype, an optional
already-rotated prefix K/V [1 or B, KV, P, D], the end-aligned causal mask,
an f32 softmax normalised before the cast to v's dtype, and the output in
[B, L, H, D]. KV may divide H. At the serving shape the cost is memory and
latency, not FLOPs: in bf16 a first kernel rotates the keys once into a
scratch copy, then one block per 64 query rows of a KV group runs on
tensor cores, each K/V tile staged once for the G heads that share it (two
kernels, one launch counted); f32 runs an exact FMA kernel. See the CUDA
source for the design. The backward, as ``_fra_bwd`` does, runs autograd
through the plain version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30
# keys a call may have: the f32 kernel keeps a 16 x S score block in shared
# memory (the bf16 kernel has no limit of its own); the decoder's routes and
# its raise for gradients past it depend on this value
MAX_KEYS = 2048


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin [L, D/2] in f32 (position * inv_freq must stay f32)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    angles = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split (llama) rotation of x [B, L, H, D] at x's dtype; cos/sin
    [L, D/2] f32 are cast to it first."""
    c = cos.to(x.dtype)[None, :, None, :]
    s = sin.to(x.dtype)[None, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_attention_plain(q, k, v, cos, sin, pk=None, pv=None, sm_scale=None):
    B, L, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qr = rope(q, cos, sin).transpose(1, 2)  # [B, H, L, D]
    kr = rope(k, cos, sin).transpose(1, 2)  # [B, KV, L, D]
    vt = v.transpose(1, 2)
    if pk is not None:
        kr = torch.cat([pk.to(kr.dtype).expand(B, -1, -1, -1), kr], dim=2)
        vt = torch.cat([pv.to(vt.dtype).expand(B, -1, -1, -1), vt], dim=2)
    S = kr.shape[2]
    q4 = qr.reshape(B, KV, G * L, D).float()
    scores = (q4 @ kr.float().transpose(-1, -2)) * sm_scale
    scores = scores.reshape(B, KV, G, L, S)
    mask = torch.ones((L, S), dtype=torch.bool, device=q.device).tril(S - L)
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = probs.reshape(B, KV, G * L, S).float() @ vt.float()
    return out.to(v.dtype).reshape(B, H, L, D).transpose(1, 2)


class _RopeAttention(torch.autograd.Function):
    """The custom_vjp of ``fused_rope_attention``: the forward is K2; the
    backward (``_fra_bwd``) recomputes the plain version under autograd and
    returns dq, dk, dv. The prefix K/V (a constant of the step, as the
    cached train path requires) and the rope tables get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, pk, pv, sm_scale):
        ctx.save_for_backward(q, k, v, cos, sin, pk, pv)
        ctx.sm_scale = sm_scale
        return _forward(q, k, v, cos, sin, pk, pv, sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, pk, pv = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = rope_attention_plain(*qkv, cos, sin, pk, pv, ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None


def rope_attention(q, k, v, cos, sin, pk=None, pv=None, sm_scale=None):
    """q [B, L, H, D], k/v [B, L, KV, D] (pre-rotary), cos/sin [L, D/2] f32,
    optional prefix pk/pv [1 or B, KV, P, D] (rotated) -> [B, L, H, D].
    Counts CUDA launches in ``rope_attention.launches``. Differentiable in
    q, k, v: the backward runs autograd through the plain version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RopeAttention.apply(q, k, v, cos, sin, pk, pv, sm_scale)
    return _forward(q, k, v, cos, sin, pk, pv, sm_scale)


def _forward(q, k, v, cos, sin, pk, pv, sm_scale):
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, cos, sin, pk, pv, sm_scale)
    B, L, H, D = q.shape
    if k.shape[:2] != (B, L) or k.shape != v.shape or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"KV heads {KV} must divide H {H}")
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64 or 128)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q/k/v must share f32 or bf16, got {q.dtype} {k.dtype} {v.dtype}")
    if cos.shape != (L, D // 2) or sin.shape != cos.shape or cos.dtype != torch.float32 \
            or sin.dtype != torch.float32:
        raise ValueError("cos/sin must be f32 [L, D/2]")
    tensors = [q, k, v, cos, sin]
    P, PB = 0, 1
    if pk is not None:
        PB, _, P, _ = pk.shape
        if pk.shape != (PB, KV, P, D) or pv.shape != pk.shape or PB not in (1, B) \
                or pk.dtype != q.dtype or pv.dtype != q.dtype:
            raise ValueError(f"prefix K/V must be [1 or B, KV, P, D] {q.dtype}, "
                             f"got {tuple(pk.shape)} {pk.dtype}")
        tensors += [pk, pv]
    if P + L > MAX_KEYS:
        raise ValueError(f"{P + L} keys exceed the kernel's {MAX_KEYS}")
    _build.check_cuda(*tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel copies 16-byte rows: q, k, v, cos, sin and the "
                         "prefix must be 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    k_rot = torch.empty_like(k) if bf16 else None  # the bf16 form's rotated keys
    ptr = _build.ptr
    _build.launch("mt_rope_attention", q.device, ptr(q), ptr(k), ptr(v), ptr(cos),
                  ptr(sin), ptr(pk), ptr(pv), ptr(out), ptr(k_rot), int(bf16),
                  B, L, H, KV, D, P, PB, ctypes.c_float(sm_scale))
    rope_attention.launches += 1
    return out


rope_attention.launches = 0
