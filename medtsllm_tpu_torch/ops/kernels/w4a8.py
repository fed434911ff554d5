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

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Forward only: the straight-through backward is not ported.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .w8a8 import int8_matmul_plain, quantize_rows

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
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

def w4a8_gemm(xq, packed, x_scale, w_scale, out_dtype=torch.float32):
    """s8 [M, K] x split-halves int4 [N, K/2] with the fused rescale -> [M, N]
    f32 / bf16, or the raw s32 accumulators when ``out_dtype`` is int32.
    Counts CUDA launches in ``w4a8_gemm.launches``."""
    if xq.device.type == "cpu":
        return w4a8_matmul_plain(xq, packed, x_scale, w_scale, out_dtype)
    if xq.dtype != torch.int8 or packed.dtype != torch.int8:
        raise ValueError("xq and packed must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError("scales must be f32")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    _build.check_cuda(xq, packed, x_scale, w_scale)
    M, K = xq.shape
    N, K2 = packed.shape
    if K != 2 * K2 or x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(f"shapes xq {tuple(xq.shape)} packed {tuple(packed.shape)} "
                         f"x_scale {tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)}")
    if K2 % 16 or xq.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("TMA reads rows 16-byte aligned: K / 2 % 16 == 0 and "
                         "16-byte aligned operands")
    if K > MAX_K:
        raise ValueError(f"K {K} > {MAX_K}: the kernel's s32 sums of 16 x the int4 "
                         "values could wrap")
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    _build.launch("mt_w4a8_gemm", xq.device, _build.ptr(xq), _build.ptr(packed),
                  _build.ptr(x_scale), _build.ptr(w_scale), _build.ptr(out),
                  _OUT_KIND[out_dtype], M, N, K)
    w4a8_gemm.launches += 1
    return out


w4a8_gemm.launches = 0


def act_quant_w4a8_matmul(x: torch.Tensor, packed: torch.Tensor, w_scale: torch.Tensor,
                          out_dtype=torch.float32) -> torch.Tensor:
    """x [..., K] -> [..., N]: K1's per-row quantizer, then K5 (two kernels
    on a CUDA tensor). K even."""
    lead = x.shape[:-1]
    xq, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    y = w4a8_gemm(xq, packed, x_scale, w_scale.float().contiguous(), out_dtype)
    return y.reshape(*lead, -1)
