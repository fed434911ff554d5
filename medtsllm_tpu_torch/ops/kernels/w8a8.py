"""K1: the w8a8 projection GEMM (``csrc/w8a8.cu``) and its plain version.

Replaces ``medtsllm_tpu/ops/pallas/smallm_matmul.py::
w8a8_smallm_matmul_pallas`` and the XLA dot of
``models/llm/transformer.py::_act_quant_matmul`` it stands in for:
per-row absmax int8 activation quantization, an s8 x s8 -> s32 product,
then ``acc * (x_scale * w_scale)``. On this card the product is bound by
the int8 tensor cores at the serving shapes: the kernel stages 128 x 256
tiles by TMA into a shared-memory ring and multiplies them with wgmma;
see the CUDA source for the design.

Layout: the weight is the transposed int8 kernel ``wq_t [N, K]`` (the JAX
package stores ``kernel_q [K, N]``; ``weights.py`` transposes once).

Training: ``act_quant_matmul`` carries the straight-through backward of
``_act_quant_matmul_bwd`` (``transformer.py:261-285``), so the gradient
reaches the trainable layers below a frozen int8 backbone. The opt-in
int8 dx GEMM (``llm.int8_backward``) is not ported (ROADMAP queue 1,
"Training on the served backbones").

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor):
    """x [M, K] float -> (xq [M, K] int8, x_scale [M] f32): round half to
    even of x / max(amax / 127, 1e-10), as jnp.round does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which can move the scale by an ulp
    x_scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-10)
    xq = torch.round(xf / x_scale).to(torch.int8)
    return xq, x_scale[:, 0]


def int8_matmul_plain(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [N, K]^T -> s32 [M, N], exact. A bare int8 matmul
    returns int8 and wraps, and CUDA has no integer matmul: the CPU widens
    to int32, the card computes in float64 (exact: K * 127^2 << 2^53)."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq_t.to(torch.int32).T
    return (xq.double() @ wq_t.double().T).to(torch.int32)


def int8_gemm_plain(xq, wq_t, x_scale, w_scale, out_dtype=torch.float32):
    """acc * (x_scale * w_scale) in f32, cast to out_dtype; the raw s32
    accumulators when out_dtype is int32."""
    acc = int8_matmul_plain(xq, wq_t)
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * (x_scale[:, None] * w_scale.float()[None, :])).to(out_dtype)


def act_quant_matmul_plain(x, wq_t, w_scale, out_dtype=torch.float32):
    xq, x_scale = quantize_rows_plain(x)
    return int8_gemm_plain(xq, wq_t, x_scale, w_scale, out_dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization of x [M, K] (f32 or bf16). Counts CUDA
    launches in ``quantize_rows.launches``."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be [M, K] f32/bf16, got {tuple(x.shape)} {x.dtype}")
    _build.check_cuda(x)
    M, K = x.shape
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    _build.launch("mt_act_quant_rows", x.device, _build.ptr(x),
                  int(x.dtype == torch.bfloat16), _build.ptr(xq), _build.ptr(x_scale),
                  M, K)
    quantize_rows.launches += 1
    return xq, x_scale


quantize_rows.launches = 0


def int8_gemm(xq, wq_t, x_scale, w_scale, out_dtype=torch.float32):
    """s8 [M, K] x s8 [N, K]^T with the fused rescale -> [M, N] f32/bf16,
    or the raw s32 accumulators when ``out_dtype`` is int32. Counts CUDA
    launches in ``int8_gemm.launches``."""
    if xq.device.type == "cpu":
        return int8_gemm_plain(xq, wq_t, x_scale, w_scale, out_dtype)
    if xq.dtype != torch.int8 or wq_t.dtype != torch.int8:
        raise ValueError("xq and wq_t must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError("scales must be f32")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    _build.check_cuda(xq, wq_t, x_scale, w_scale)
    M, K = xq.shape
    N, K2 = wq_t.shape
    if K != K2 or x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(f"shapes xq {tuple(xq.shape)} wq_t {tuple(wq_t.shape)} "
                         f"x_scale {tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)}")
    if K % 16 or xq.data_ptr() % 16 or wq_t.data_ptr() % 16:
        raise ValueError("TMA reads rows 16-byte aligned: K % 16 == 0 and "
                         "16-byte aligned operands")
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    _build.launch("mt_w8a8_gemm", xq.device, _build.ptr(xq), _build.ptr(wq_t),
                  _build.ptr(x_scale), _build.ptr(w_scale), _build.ptr(out),
                  _OUT_KIND[out_dtype], M, N, K)
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def _act_quant_matmul(x, wq_t, w_scale, out_dtype):
    lead = x.shape[:-1]
    xq, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    y = int8_gemm(xq, wq_t, x_scale, w_scale.float().contiguous(), out_dtype)
    return y.reshape(*lead, -1)


class _ActQuantMatmul(torch.autograd.Function):
    """The custom_vjp of ``transformer.py::_act_quant_matmul``: the forward is
    K1; the backward is the straight-through estimator, the quantization
    taken as identity and the gradient sent through the dequantized weight,
    ``dx = (g * scale) @ W_q`` at g's dtype with the scale folded into g
    (O(M N), not O(K N)). A plain matmul, as JAX leaves it to an XLA dot.
    The int8 weight and its scale are frozen: no gradient."""

    @staticmethod
    def forward(ctx, x, wq_t, w_scale, out_dtype):
        ctx.save_for_backward(wq_t, w_scale)
        ctx.x_dtype = x.dtype
        return _act_quant_matmul(x, wq_t, w_scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        wq_t, w_scale = ctx.saved_tensors
        dx = (g * w_scale.to(g.dtype)) @ wq_t.to(g.dtype)
        return dx.to(ctx.x_dtype), None, None, None


def act_quant_matmul(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """x [..., K] -> [..., N]: quantize rows, int8 GEMM, rescale (the
    transformer's w8a8 projection: two kernels on a CUDA tensor).
    Differentiable in x through the straight-through estimator when x
    requires grad."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ActQuantMatmul.apply(x, wq_t, w_scale, out_dtype)
    return _act_quant_matmul(x, wq_t, w_scale, out_dtype)
