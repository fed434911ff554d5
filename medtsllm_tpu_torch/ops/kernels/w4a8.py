"""K5: the w4a8 projection GEMM (``csrc/w4a8.cu``) and its plain version,
with the split-halves int4 format and the bnb 4-bit codebooks.

Replaces ``medtsllm_tpu/ops/pallas/quant_matmul.py::w4a8_matmul_pallas``
and the XLA unpack-then-dot it stands in for (``w4a8_matmul_reference``):
an int8 activation [M, K] (K1's per-row quantizer) against packed int4
weights, an exact s8 x s8 -> s32 product, then ``(acc * x_scale) *
w_scale`` in f32 -- the scales applied one after the other, not K1's
``acc * (x_scale * w_scale)``: the two differ in the last bit.

Layout: ``pack4_split`` along the last axis. The weight is ``[N,
ceil(K/2)]`` int8, the JAX ``kernel_q [ceil(K/2), N]`` transposed
(``weights.py``); byte p of a row holds logical k = p in its high nibble and
k = p + ceil(K/2) in its low one (odd K pads the last low nibble with 0).
The kernel (K1's wgmma + TMA pipeline with the operands swapped) stages the
packed tile by TMA and unpacks each thread's nibbles in registers straight
into wgmma's A fragments: no unpacked copy of the weight exists, and it
reads half the weight bytes of K1.

Training (``act_quant_w4a8_matmul`` with x requiring grad): the
straight-through backward of ``_act_quant_matmul_bwd`` at 4 bits
(``transformer.py:261-285``): the weight unpacked, then ``dx = (g * scale)
@ W`` at g's dtype, or with ``llm.int8_backward`` K1's int8 dx on the
unpacked weight's ``[K, N]`` copy, as JAX unpacks first (``:264``).

Shapes: TMA reads the packed rows 16 bytes at a time, so K / 2 must be a
multiple of 16. A weight whose K is not a multiple of 32 is repacked once
by its owner with zero columns up to the next one (``pad_packed``) and the
codes are padded per call; the s32 sums are unchanged. The GEMM is a
``torch.library`` custom op (``medtsllm::w4a8_gemm``; its CPU kernel the
plain version) for ``torch.export`` and for the selective checkpoint
policy of ``llm.remat = "dots"``.

Operands: the codes, the packed weight and the scales must be contiguous
(the kernel reads dense rows), the codes and the weight 16-byte aligned;
``act_quant_w4a8_matmul`` makes its activations contiguous first. Any other
layout raises a ValueError that names the tensor.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .w8a8 import _dx, int8_matmul_plain, pad_cols, quantize_rows

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_KIND_DTYPE = {v: k for k, v in _OUT_KIND.items()}
MAX_K = 131072  # the kernel accumulates 16 x w: 16 * K * 127 * 8 < 2^31

# bnb 4-bit dequant codebooks (medtsllm_tpu/models/llm/transformer.py
# _NF4_TABLE / _FP4_TABLE): code c (0..15) stands for table[c], stored as
# the int4 value c - 8
CODEBOOKS = {
    "nf4": (-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
            -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
            0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
            0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
            0.7229568362236023, 1.0),
    "fp4": (0.0, 0.0052083333, 0.6666667, 1.0, 0.3333333, 0.5, 0.16666667, 0.25,
            -0.0, -0.0052083333, -0.6666667, -1.0, -0.3333333, -0.5, -0.16666667,
            -0.25),
}


# --------------------------------------------------------------------------
# the format and the plain version
# --------------------------------------------------------------------------

def pack4_split(q: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 in [-8, 7] -> [..., ceil(K/2)] packed split halves."""
    K = q.shape[-1]
    half = (K + 1) // 2
    if K != 2 * half:
        q = torch.cat([q, q.new_zeros(*q.shape[:-1], 1)], dim=-1)
    hi, lo = q[..., :half].to(torch.int16), q[..., half:].to(torch.int16)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack4_split(packed: torch.Tensor, n_in: int) -> torch.Tensor:
    """Inverse of ``pack4_split``: [..., ceil(n_in/2)] -> [..., n_in] int8."""
    hi = packed >> 4  # arithmetic: keeps the sign
    lo = ((packed & 0xF) ^ 8) - 8  # the low nibble sign-extended, no wrap
    return torch.cat([hi, lo], dim=-1)[..., :n_in]


@functools.cache
def codebook_table(codebook: str, device: torch.device) -> torch.Tensor:
    """The codebook's f32 table on ``device``, made once per device: a step
    captured into a CUDA graph reads it with no host-to-device copy. A
    normal tensor even when first asked for under inference mode."""
    with torch.inference_mode(False):
        return torch.tensor(CODEBOOKS[codebook], dtype=torch.float32).to(device)


def pad_packed(packed: torch.Tensor, n_in: int) -> torch.Tensor:
    """Split-halves weights [..., ceil(n_in/2)] repacked with zero columns up
    to a multiple of 32 logical columns (the GEMM's 16-byte packed rows)."""
    return pack4_split(pad_cols(unpack4_split(packed, n_in), 32))


def dequant_codebook(packed: torch.Tensor, n_in: int, codebook: str) -> torch.Tensor:
    """Packed codebook weights -> their f32 table values [..., n_in] (the
    scale is applied after the matmul)."""
    return codebook_table(codebook, packed.device)[unpack4_split(packed, n_in).long() + 8]


def w4a8_matmul_plain(xq, packed, x_scale, w_scale, out_dtype=torch.float32):
    """s8 [M, K] x packed int4 [N, K/2] -> ``(acc * x_scale) * w_scale`` in
    f32, cast to out_dtype; the raw s32 accumulators when out_dtype is int32."""
    acc = int8_matmul_plain(xq, unpack4_split(packed, xq.shape[1]))
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * x_scale[:, None] * w_scale.float()[None, :]).to(out_dtype)


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

@torch.library.custom_op("medtsllm::w4a8_gemm", mutates_args=(), device_types="cuda")
def _gemm_op(xq: torch.Tensor, packed: torch.Tensor, x_scale: torch.Tensor,
             w_scale: torch.Tensor, out_kind: int) -> torch.Tensor:
    """K5's launch as a custom op (the wrapper has checked its operands'
    shapes; the addresses are read here)."""
    _build.check_aligned((xq, packed), "TMA reads rows 16-byte aligned: K / 2 % 16 == 0 "
                         "and 16-byte aligned operands")
    M, K = xq.shape
    N = packed.shape[0]
    out = torch.empty((M, N), dtype=_KIND_DTYPE[out_kind], device=xq.device)
    _build.launch("mt_w4a8_gemm", xq.device, _build.ptr(xq), _build.ptr(packed),
                  _build.ptr(x_scale), _build.ptr(w_scale), _build.ptr(out),
                  out_kind, M, N, K)
    w4a8_gemm.launches += 1
    return out


@_gemm_op.register_kernel("cpu")
def _(xq, packed, x_scale, w_scale, out_kind):
    return _build.op_outputs(w4a8_matmul_plain(xq, packed, x_scale, w_scale,
                                               _KIND_DTYPE[out_kind]), xq, packed, x_scale,
                             w_scale)


@_gemm_op.register_fake
def _(xq, packed, x_scale, w_scale, out_kind):
    return xq.new_empty((xq.shape[0], packed.shape[0]), dtype=_KIND_DTYPE[out_kind])


def w4a8_gemm(xq, packed, x_scale, w_scale, out_dtype=torch.float32):
    """s8 [M, K] x split-halves int4 [N, K/2] with the fused rescale -> [M, N]
    f32 / bf16, or the raw s32 accumulators when ``out_dtype`` is int32,
    through the op ``medtsllm::w4a8_gemm``. Counts CUDA launches in
    ``w4a8_gemm.launches``."""
    if xq.device.type == "cpu":
        if out_dtype not in _OUT_KIND or _build.wants_grad(x_scale, w_scale):
            return w4a8_matmul_plain(xq, packed, x_scale, w_scale, out_dtype)
        return _gemm_op(xq, packed, x_scale, w_scale, _OUT_KIND[out_dtype])
    if xq.dtype != torch.int8 or packed.dtype != torch.int8:
        raise ValueError("xq and packed must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError("scales must be f32")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    _build.check_cuda(xq, packed, x_scale, w_scale, names="xq packed x_scale w_scale")
    M, K = xq.shape
    N, K2 = packed.shape
    if K != 2 * K2 or x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(f"shapes xq {tuple(xq.shape)} packed {tuple(packed.shape)} "
                         f"x_scale {tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)}")
    if K2 % 16:
        raise ValueError("TMA reads rows 16-byte aligned: K / 2 % 16 == 0 and "
                         "16-byte aligned operands")
    if K > MAX_K:
        raise ValueError(f"K {K} > {MAX_K}: the kernel's s32 sums of 16 x the int4 "
                         "values could wrap")
    return _gemm_op(xq, packed, x_scale, w_scale, _OUT_KIND[out_dtype])


w4a8_gemm.launches = 0


def _act_quant_w4a8(x, packed, w_scale, out_dtype):
    lead = x.shape[:-1]
    xq, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    if 2 * packed.shape[1] != xq.shape[1]:  # a weight repacked to the GEMM's width
        xq = pad_cols(xq, 2 * packed.shape[1])
    y = w4a8_gemm(xq, packed, x_scale, w_scale.float().contiguous(), out_dtype)
    return y.reshape(*lead, -1)


class _ActQuantW4Matmul(torch.autograd.Function):
    """``_act_quant_matmul`` at 4 bits (its custom_vjp): the forward is K1's
    quantizer and K5; the backward unpacks the weight and takes the
    straight-through ``(g * scale) @ W`` at g's dtype, or the int8 dx on
    the unpacked weight's ``[K, N]`` copy (``w_kn``, ``llm.int8_backward``).
    The packed weight and its scale are frozen: no gradient."""

    @staticmethod
    def forward(ctx, x, packed, w_scale, out_dtype, w_kn):
        ctx.save_for_backward(packed, w_scale)
        ctx.x_shape, ctx.x_dtype, ctx.w_kn = x.shape, x.dtype, w_kn
        return _act_quant_w4a8(x, packed, w_scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        packed, w_scale = ctx.saved_tensors
        w = None if ctx.w_kn is not None else unpack4_split(packed, 2 * packed.shape[1])
        return _dx(g, ctx.x_shape, ctx.x_dtype, w, w_scale, ctx.w_kn), None, None, None, None


def act_quant_w4a8_matmul(x: torch.Tensor, packed: torch.Tensor, w_scale: torch.Tensor,
                          out_dtype=torch.float32, w_kn=None) -> torch.Tensor:
    """x [..., K] -> [..., N]: K1's per-row quantizer, then K5 (two kernels
    on a CUDA tensor). K even; ``packed`` [N, K/2] or repacked to a
    multiple of 32 columns (``pad_packed``). Differentiable in x when x
    requires grad (``_ActQuantW4Matmul``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ActQuantW4Matmul.apply(x, packed, w_scale, out_dtype, w_kn)
    return _act_quant_w4a8(x, packed, w_scale, out_dtype)
