"""K3: reprogramming cross-attention (``csrc/reprogramming.cu``) and its
plain version.

Replaces ``medtsllm_tpu/ops/pallas/reprogramming.py::
reprogramming_attention``: softmax(scale * q k^T) v per (batch, head), with
q [B, L, H, E] against a K/V basis [S, H, E] shared by the whole batch, all
in f32. The kernel folds the batch into the query rows (per head, the B * L
rows share the basis) on f32 FMA micro-tiles, and where those rows give
too few blocks it splits S across blocks and merges the splits exactly;
see the CUDA source.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

ROW_TILE = 64  # query rows per block, across the batch
KEY_TILE = 64  # keys per staged tile
SMS = 132      # the H100's SMs


def reprogramming_attention_plain(q, k, v, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("blhe,she->bhls", q, k)
    attn = torch.softmax(scale * scores, dim=-1)
    return torch.einsum("bhls,she->blhe", attn, v)


def split_plan(rows: int, heads: int, keys: int) -> tuple[int, int]:
    """(splits, key tiles per split) of the kernel's grid: the rule of
    ``split_plan`` in the CUDA source, restated for the CPU reference
    (the wrapper sizes its scratch from the C rule; a card test holds the
    two equal). With fewer than two blocks per SM
    from the query rows alone (heads x ceil(rows / 64)), split the key
    tiles so that there are about two, never more splits than tiles, and
    no empty split."""
    tiles = -(-keys // KEY_TILE)
    base = heads * -(-rows // ROW_TILE)
    splits = 1 if base >= 2 * SMS else min(-(-2 * SMS // base), tiles)
    per = -(-tiles // splits)
    return -(-tiles // per), per


def reprogramming_attention_split(q, k, v, scale=None, splits=None):
    """The kernel's algorithm in PyTorch: the keys cut into ``splits``
    ranges of whole tiles (``split_plan`` by default), each range's
    unnormalised ``acc`` with its row max ``m`` and sum ``l``, then the
    exact merge ``sum_i exp(m_i - m) acc_i / sum_i exp(m_i - m) l_i``.
    The reference of the kernel's split and merge, on any device."""
    B, L, H, E = q.shape
    S = k.shape[0]
    if scale is None:
        scale = 1.0 / math.sqrt(E)
    tiles = -(-S // KEY_TILE)
    per = split_plan(B * L, H, S)[1] if splits is None else -(-tiles // splits)
    parts = []
    for s0 in range(0, S, per * KEY_TILE):
        ks, vs = k[s0:s0 + per * KEY_TILE], v[s0:s0 + per * KEY_TILE]
        scores = scale * torch.einsum("blhe,she->bhls", q, ks)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum("bhls,she->bhle", p, vs)))
    m = torch.stack([m_i for m_i, _, _ in parts]).amax(0)
    w = [torch.exp(m_i - m) for m_i, _, _ in parts]
    l = sum(w_i * l_i for w_i, (_, l_i, _) in zip(w, parts))
    acc = sum(w_i * a_i for w_i, (_, _, a_i) in zip(w, parts))
    return (acc / l).permute(0, 2, 1, 3)


def reprogramming_attention(q, k, v, scale=None):
    """q [B, L, H, E], k/v [S, H, E], f32 -> [B, L, H, E]. Counts CUDA
    launches in ``reprogramming_attention.launches`` (one per call, the
    merge of a split call included)."""
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel reads q, k and v as 16-byte vectors: "
                         "16-byte aligned tensors")
    if scale is None:
        scale = 1.0 / math.sqrt(E)
    out = torch.empty_like(q)
    splits = _build.library().mt_reprogramming_splits(B * L, H, S)
    part = part_ml = None
    if splits > 1:  # each split's unnormalised acc and its (m, l)
        part = torch.empty((splits, H, B * L, E), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, H, B * L, 2), dtype=torch.float32, device=q.device)
    _build.launch("mt_reprogramming_attention", q.device, _build.ptr(q), _build.ptr(k),
                  _build.ptr(v), _build.ptr(out), _build.ptr(part), _build.ptr(part_ml),
                  B, L, H, E, S, ctypes.c_float(scale))
    reprogramming_attention.launches += 1
    return out


reprogramming_attention.launches = 0
