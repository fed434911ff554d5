"""K3: reprogramming cross-attention (``csrc/reprogramming.cu``) and its
plain version.

Replaces ``medtsllm_tpu/ops/pallas/reprogramming.py::
reprogramming_attention``: softmax(scale * q k^T) v per (batch, head), with
q [B, L, H, E] against a K/V basis [S, H, E] shared by the whole batch, all
in f32. One head's basis exceeds shared memory, so the kernel streams it
under an online softmax and runs head-major for L2 reuse; see the CUDA
source.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build


def reprogramming_attention_plain(q, k, v, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("blhe,she->bhls", q, k)
    attn = torch.softmax(scale * scores, dim=-1)
    return torch.einsum("bhls,she->blhe", attn, v)


def reprogramming_attention(q, k, v, scale=None):
    """q [B, L, H, E], k/v [S, H, E], f32 -> [B, L, H, E]. Counts CUDA
    launches in ``reprogramming_attention.launches``."""
    if q.device.type == "cpu":
        return reprogramming_attention_plain(q, k, v, scale)
    B, L, H, E = q.shape
    S = k.shape[0]
    if k.shape != (S, H, E) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if E not in (32, 64, 128):
        raise ValueError(f"head width {E} not supported (32, 64 or 128)")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError(f"q/k/v must be f32, got {q.dtype} {k.dtype} {v.dtype}")
    _build.check_cuda(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(E)
    out = torch.empty_like(q)
    _build.launch("mt_reprogramming_attention", q.device, _build.ptr(q), _build.ptr(k),
                  _build.ptr(v), _build.ptr(out), B, L, H, E, S, ctypes.c_float(scale))
    reprogramming_attention.launches += 1
    return out


reprogramming_attention.launches = 0
