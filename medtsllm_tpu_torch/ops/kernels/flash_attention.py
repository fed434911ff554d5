"""K4: blocked online-softmax attention (``csrc/flash_attention.cu``), the
long-window route with RoPE and the prefix folded in, and their plain
versions.

Replaces ``medtsllm_tpu/ops/pallas/flash_attention.py::flash_attention``
(``_flash_attention_pallas`` / ``_flash_kernel``), forward only, as the JAX
kernel defines no custom_vjp. Two entries launch the same kernel:

- ``flash_attention(q, k, v, causal)``: the JAX function's interface, q
  [B, H, L, D] already rotated against k/v [B, KV, S, D] -> [B, H, L, D],
  KV dividing H (query row ``b * H + h`` reads kv row
  ``b * KV + h // (H / KV)``), end-aligned causal (query i sees keys
  <= i + S - L) or non-causal;
- ``rope_flash_attention(q, k, v, cos, sin, pk, pv)``: the decoder's
  long-window route (``transformer.py:591-633`` of the JAX package) in K2's
  interface, q [B, L, H, D] and k/v [B, L, KV, D] in the projection layout
  before rotary, an optional rotated prefix [1 or B, KV, P, D] ->
  [B, L, H, D], end-aligned causal. ``rope_flash_keys`` (a pre-pass kernel,
  counted apart) writes [prefix | rotated keys] and [prefix | values] in
  [B, KV, S, D]; the main kernel rotates q as it loads it. Both rotations
  are K2's: f32 with the tables rounded to the compute dtype, one rounding
  (``rope_once``); the plain version rotates with torch's ``rope``.

The kernel never holds the [L, S] scores: it keeps an f32 running max, sum
and accumulator per query row and writes ``acc / max(l, 1e-30)`` rounded to
q's dtype. The t5 additive bias is not ported (it takes JAX's reference
path; ROADMAP queue 1, "Other backbone families and LoRA").

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .rope_attention import rope

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


def _no_grad(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward (the JAX kernel defines none): "
            "training above 2048 keys is ROADMAP queue 1, \"Training on the served backbones\"")


def _check_dims(B, H, KV, D, dtypes):
    if H % KV:
        raise ValueError(f"KV heads {KV} must divide H {H}")
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64 or 128)")
    if dtypes[0] not in (torch.float32, torch.bfloat16) or len(set(dtypes)) != 1:
        raise ValueError(f"q/k/v must share f32 or bf16, got {dtypes}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")


def _check_aligned(*tensors):
    if any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError("the kernel's operands must start on a 16-byte boundary (TMA "
                         "tiles and 16-byte rows)")


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """q [B, H, L, D], k/v [B, KV, S, D] -> [B, H, L, D]. Counts CUDA
    launches in ``flash_attention.launches``. Forward only."""
    _no_grad("flash_attention", q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    B, H, L, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    KV, S = k.shape[1], k.shape[2]
    _check_dims(B, H, KV, D, (q.dtype, k.dtype, v.dtype))
    if L == 0 or S == 0 or (causal and L > S):
        raise ValueError(f"L {L} S {S}: the kernel needs L, S > 0 and, when causal, "
                         "L <= S (every query row sees a key)")
    _build.check_cuda(q, k, v)
    _check_aligned(q, k, v)
    out = torch.empty_like(q)
    ptr = _build.ptr
    _build.launch("mt_flash_attention", q.device, ptr(q), ptr(k), ptr(v), ptr(out),
                  int(q.dtype == torch.bfloat16), int(causal), B, H, KV, L, S, D,
                  ctypes.c_float(sm_scale))
    flash_attention.launches += 1
    return out


def rope_once(x, cos, sin):
    """The kernels' rotation of x [B, L, H, D] (K2's ``rope_pair``): f32
    products with the f32 tables [L, D/2] rounded to x's dtype first, one
    rounding to x's dtype at the end (torch's ``rope`` rounds after each of
    its three ops; in f32 the two agree)."""
    c = cos.to(x.dtype).float()[None, :, None, :]
    s = sin.to(x.dtype).float()[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _concat(kr, vt, pk, pv):
    B = kr.shape[0]
    if pk is not None:
        kr = torch.cat([pk.to(kr.dtype).expand(B, -1, -1, -1), kr], dim=2)
        vt = torch.cat([pv.to(vt.dtype).expand(B, -1, -1, -1), vt], dim=2)
    return kr.contiguous(), vt.contiguous()


def rope_flash_keys_plain(k, v, cos, sin, pk=None, pv=None):
    """The pre-pass: k/v [B, L, KV, D] (k before rotary), the rotated
    prefix pk/pv [1 or B, KV, P, D] -> (keys, values) [B, KV, P + L, D]:
    [prefix | ``rope_once(k)``] and [prefix | v]."""
    return _concat(rope_once(k, cos, sin).transpose(1, 2), v.transpose(1, 2), pk, pv)


def _check_route(q, k, v, cos, sin, pk, pv):
    """The route's operands for the kernels -> (B, L, H, KV, D, P, PB)."""
    B, L, H, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, L) or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    KV = k.shape[2]
    _check_dims(B, H, KV, D, (q.dtype, k.dtype, v.dtype))
    if L == 0:
        raise ValueError("the route needs L > 0")
    if cos.shape != (L, D // 2) or sin.shape != cos.shape or cos.dtype != torch.float32 \
            or sin.dtype != torch.float32:
        raise ValueError("cos/sin must be f32 [L, D/2]")
    P, PB = 0, 1
    if pk is not None:
        PB, _, P, _ = pk.shape
        if pk.shape != (PB, KV, P, D) or pv is None or pv.shape != pk.shape \
                or PB not in (1, B) or pk.dtype != q.dtype or pv.dtype != q.dtype:
            raise ValueError(f"prefix K/V must be [1 or B, KV, P, D] {q.dtype}, "
                             f"got {tuple(pk.shape)} {pk.dtype}")
    tensors = [q, k, v, cos, sin] + ([pk, pv] if P else [])
    _build.check_cuda(*tensors)
    _check_aligned(*tensors)
    return B, L, H, KV, D, P, PB


def rope_flash_keys(k, v, cos, sin, pk=None, pv=None):
    """The pre-pass kernel (``mt_flash_keys``): the region's keys rotated
    once and the prefix put ahead of keys and values -> (keys, values)
    [B, KV, P + L, D]. Counts CUDA launches in ``rope_flash_keys.launches``."""
    if k.device.type == "cpu":
        return rope_flash_keys_plain(k, v, cos, sin, pk, pv)
    B, L, KV, D = k.shape
    # the checks of the route, with k standing in for q
    _, _, _, _, _, P, PB = _check_route(k, k, v, cos, sin, pk, pv)
    kc = torch.empty(B, KV, P + L, D, dtype=k.dtype, device=k.device)
    vc = torch.empty_like(kc)
    ptr = _build.ptr
    _build.launch("mt_flash_keys", k.device, ptr(k), ptr(v), ptr(cos), ptr(sin),
                  ptr(pk if P else None), ptr(pv if P else None), ptr(kc), ptr(vc),
                  int(k.dtype == torch.bfloat16), B, L, KV, D, P, PB)
    rope_flash_keys.launches += 1
    return kc, vc


def rope_flash_attention_plain(q, k, v, cos, sin, pk=None, pv=None, sm_scale=None,
                               return_kv: bool = False):
    """The route as JAX composes it: torch's ``rope`` on q and k in the
    projection layout, the transposes to [B, H|KV, L, D], the prefix ahead
    of k/v, end-aligned causal ``flash_attention_plain``, the output
    transposed back to [B, L, H, D]. ``return_kv`` also returns the
    region's rotated (k, v) [B, KV, L, D]."""
    kr, vt = rope(k, cos, sin).transpose(1, 2), v.transpose(1, 2)
    keys, values = _concat(kr, vt, pk, pv)
    out = flash_attention_plain(rope(q, cos, sin).transpose(1, 2), keys, values, True,
                                sm_scale).transpose(1, 2)
    if not return_kv:
        return out
    return out, (kr.contiguous(), vt.contiguous())


def rope_flash_attention(q, k, v, cos, sin, pk=None, pv=None, sm_scale=None,
                         return_kv: bool = False):
    """q [B, L, H, D], k/v [B, L, KV, D] (pre-rotary), cos/sin [L, D/2] f32,
    optional prefix pk/pv [1 or B, KV, P, D] (rotated) -> [B, L, H, D],
    end-aligned causal. ``return_kv`` also returns the region's rotated
    (k, v) [B, KV, L, D], the prefill's cache: on the card the pre-pass's
    own keys and values, so a later call attends with the bits this one did.
    Counts CUDA launches in ``rope_flash_attention.launches`` (the pre-pass
    in ``rope_flash_keys.launches``). Forward only."""
    _no_grad("rope_flash_attention", q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return rope_flash_attention_plain(q, k, v, cos, sin, pk, pv, sm_scale, return_kv)
    B, L, H, KV, D, P, PB = _check_route(q, k, v, cos, sin, pk, pv)
    keys, values = rope_flash_keys(k, v, cos, sin, pk, pv)
    out = torch.empty_like(q)
    f32 = q.dtype == torch.float32
    q_rot = torch.empty_like(q) if f32 else None  # the f32 form rotates q first
    ptr = _build.ptr
    _build.launch("mt_rope_flash_attention", q.device, ptr(q), ptr(keys), ptr(values),
                  ptr(cos), ptr(sin), ptr(out), ptr(q_rot), int(not f32), B, L, H, KV, D,
                  P + L, ctypes.c_float(sm_scale))
    rope_flash_attention.launches += 1
    if not return_kv:
        return out
    if P:
        return out, (keys[:, :, P:].contiguous(), values[:, :, P:].contiguous())
    return out, (keys, values)


flash_attention.launches = 0
rope_flash_keys.launches = 0
rope_flash_attention.launches = 0
