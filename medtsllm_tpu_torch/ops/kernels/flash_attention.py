"""K4: blocked online-softmax attention (``csrc/flash_attention.cu``) and
its plain version.

Replaces ``medtsllm_tpu/ops/pallas/flash_attention.py::flash_attention``
(``_flash_attention_pallas`` / ``_flash_kernel``), forward only, as the JAX
kernel defines no custom_vjp: q [B, H, L, D] against k/v [B, KV, S, D] ->
[B, H, L, D], KV dividing H (query row ``b * H + h`` reads kv row
``b * KV + h // (H / KV)``), end-aligned causal (query i sees keys
<= i + S - L) or non-causal. The kernel never holds the [L, S] scores: it
keeps an f32 running max, sum and accumulator per query row and writes
``acc / max(l, 1e-30)`` rounded to q's dtype. The t5 additive bias is not
ported (it takes JAX's reference path; ROADMAP queue 1 item 7).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30


def flash_attention_plain(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """``_attention_reference`` (flash_attention.py:47-78) without the
    bias: the group folded into the query rows, f32 scores x scale, the
    end-aligned mask ``tril(k = S - L)`` filled with -1e30, an f32 softmax,
    the probabilities cast to v's dtype, then PV."""
    B, H, L, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q4 = q.reshape(B, KV, G * L, D).float()
    scores = ((q4 @ k.float().transpose(-1, -2)) * sm_scale).reshape(B, KV, G, L, S)
    if causal:
        mask = torch.ones((L, S), dtype=torch.bool, device=q.device).tril(S - L)
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = probs.reshape(B, KV, G * L, S).float() @ v.float()
    return out.to(v.dtype).reshape(B, H, L, D)


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """q [B, H, L, D], k/v [B, KV, S, D] -> [B, H, L, D]. Counts CUDA
    launches in ``flash_attention.launches``. Forward only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward (the JAX kernel defines none): "
            "training above 2048 keys is ROADMAP queue 1 item 4")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    B, H, L, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    KV, S = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"KV heads {KV} must divide H {H}")
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64 or 128)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q/k/v must share f32 or bf16, got {q.dtype} {k.dtype} {v.dtype}")
    if L == 0 or S == 0 or (causal and L > S):
        raise ValueError(f"L {L} S {S}: the kernel needs L, S > 0 and, when causal, "
                         "L <= S (every query row sees a key)")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")
    _build.check_cuda(q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q/k/v must start on a 16-byte boundary (the kernel loads "
                         "16-byte rows)")
    out = torch.empty_like(q)
    ptr = _build.ptr
    _build.launch("mt_flash_attention", q.device, ptr(q), ptr(k), ptr(v), ptr(out),
                  int(q.dtype == torch.bfloat16), int(causal), B, H, KV, L, S, D,
                  ctypes.c_float(sm_scale))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
