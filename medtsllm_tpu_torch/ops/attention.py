"""The attention family (port of ``medtsllm_tpu/ops/attention.py``):
``FullAttention``, ``DSAttention``, ``ProbAttention``, the projection
wrapper ``AttentionLayer`` and the LSH ``ReformerLayer``.

Each is the plain einsum-softmax-einsum that JAX computes as XLA ops (no
Pallas kernel): the sequences here are patch counts, a few dozen to a few
hundred. Every inner attention takes ``(queries, keys, values, attn_mask,
generator)`` and the keywords ``tau`` / ``delta`` (the Non-stationary
Transformer's de-stationary factors), which only ``DSAttention`` reads.

Where the reference and the JAX package part, the port keeps JAX's choice:
``ProbAttention`` samples its keys at fixed strided positions (JAX's
``jnp.linspace`` indices, reproduced bit for bit; the reference draws them
at random) and returns [B, L, H, D] (the reference leaves [B, H, L, D]);
``ReformerLayer`` is JAX's own LSH attention (``ops/lsh_attention.py``), not
reformer_pytorch's. Its default hash rotations are not JAX's numbers: JAX
draws them from ``jax.random`` under a key salted by the flax module path;
the port draws them from a ``torch.Generator`` seeded with the same key
(``ReformerLayer(path=...)``). A caller that needs JAX's hashes passes the
rotations in.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from ..models.llm.transformer import Linear
from .embed import dropout
from .lsh_attention import lsh_attention, lsh_buckets, n_buckets
from .masks import prob_mask, triangular_causal_mask


def _softmax_values(module: nn.Module, scores, scale, values, generator):
    """softmax(scale * scores) (dropout on it in training) over S, then the
    weighted values: (V [B, L, H, D], A [B, H, L, S])."""
    A = torch.softmax(scale * scores, dim=-1)
    if module.training:
        A = dropout(A, module.p, generator)
    return torch.einsum("bhls,bshd->blhd", A, values), A


def _masked(module: nn.Module, scores, attn_mask):
    if not module.mask_flag:
        return scores
    L, S = scores.shape[-2:]
    mask = triangular_causal_mask(L, S, scores.device) if attn_mask is None else attn_mask
    return scores.masked_fill(mask, -math.inf)


class FullAttention(nn.Module):
    """queries [B, L, H, E], keys / values [B, S, H, E] -> ([B, L, H, E], the
    weights [B, H, L, S] with ``output_attention``, else None), scaled by
    1 / sqrt(E); the causal mask (or ``attn_mask``, True where masked)
    under ``mask_flag``; dropout ``p`` on the weights in training."""

    def __init__(self, mask_flag: bool = True, p: float = 0.1, output_attention: bool = False):
        super().__init__()
        self.mask_flag, self.p = mask_flag, p
        self.output_attention = output_attention

    def forward(self, queries, keys, values, attn_mask=None, generator=None, *, tau=None,
                delta=None):
        scores = torch.einsum("blhe,bshe->bhls", queries, keys)
        V, A = _softmax_values(self, _masked(self, scores, attn_mask),
                               1.0 / math.sqrt(queries.shape[-1]), values, generator)
        return V, (A if self.output_attention else None)


class DSAttention(FullAttention):
    """De-stationary attention: ``FullAttention`` with the scores rescaled
    before the mask, ``scores * tau + delta``; ``tau`` [B] (1 when None),
    ``delta`` [B, S] (0 when None)."""

    def forward(self, queries, keys, values, attn_mask=None, generator=None, *, tau=None,
                delta=None):
        scores = torch.einsum("blhe,bshe->bhls", queries, keys)
        if tau is not None:
            scores = scores * tau[:, None, None, None]
        if delta is not None:
            scores = scores + delta[:, None, None, :]
        V, A = _softmax_values(self, _masked(self, scores, attn_mask),
                               1.0 / math.sqrt(queries.shape[-1]), values, generator)
        return V, (A if self.output_attention else None)


def prob_sample_index(L_K: int, U: int) -> np.ndarray:
    """``jnp.linspace(0, L_K - 1, U).astype(int32)`` bit for bit, as int64.

    JAX computes ``start * (1 - s) + stop * s`` with s = i / (U - 1) in f32,
    and XLA turns the division into a multiplication by the f32 reciprocal
    r = 1 / (U - 1) and reassociates: index i is trunc((stop * r) * i), each
    product rounded to f32, and the last is stop. ``torch.linspace`` and
    numpy's linspace (f64 or f32) round elsewhere: at (L_K, U) = (17, 15),
    (123, 15) or (1262, 40) they pick other keys."""
    if U == 1:
        return np.zeros(1, np.int64)
    r = np.float32(1.0) / np.float32(U - 1)
    i = np.arange(U - 1, dtype=np.float32)
    return np.append(((np.float32(L_K - 1) * r) * i).astype(np.int64), L_K - 1)


class ProbAttention(nn.Module):
    """Informer's sparse attention, with JAX's static shapes: U = factor x
    ceil(ln L_K) keys at ``prob_sample_index``'s strided positions score
    every query; the u = factor x ceil(ln L_Q) queries of the largest
    sparsity measure (``select``) attend to every key (the causal mask's
    rows at them under ``mask_flag``), and the others take the prior: the
    mean of the values, or their cumulative sum when causal. queries [B, L,
    H, D] -> ([B, L, H, D], None); ``attn_mask`` is not read (the mask is
    causal or none), as in JAX. The scatter of the attended rows into the
    prior is JAX's one-hot einsum. ``index`` [B, H, u] replaces
    ``select``'s choice when given, so a caller can hold one device against
    another on the same queries: an ulp in the measure can reorder two
    queries at the u-th place."""

    def __init__(self, mask_flag: bool = True, factor: int = 5, p: float = 0.1):
        super().__init__()
        self.mask_flag, self.factor, self.p = mask_flag, factor, p

    def _u(self, L: int) -> int:
        return min(int(self.factor * math.ceil(math.log(L))), L)

    def select(self, queries, keys) -> torch.Tensor:
        """The top-u queries [B, H, u] by the sparsity measure max - sum /
        L_K of their sampled scores (the sum over the FULL key count, as
        the reference divides)."""
        L_K = keys.shape[1]
        U_part = self._u(L_K)
        idx = device_constant(("prob_sample", L_K, U_part),
                              lambda: prob_sample_index(L_K, U_part), queries.device)
        scores_sample = torch.einsum("blhd,buhd->bhlu", queries, keys[:, idx])
        M = scores_sample.amax(-1) - scores_sample.sum(-1) / L_K
        return torch.topk(M, self._u(queries.shape[1]), dim=-1).indices

    def forward(self, queries, keys, values, attn_mask=None, generator=None, *, tau=None,
                delta=None, index=None):
        L_Q, D = queries.shape[1], queries.shape[-1]
        top_idx = self.select(queries, keys) if index is None else index
        q, k, v = (t.transpose(1, 2) for t in (queries, keys, values))  # [B, H, L, D]
        q_top = torch.gather(q, 2, top_idx[..., None].expand(-1, -1, -1, D))
        scores = torch.einsum("bhud,bhkd->bhuk", q_top, k)
        if self.mask_flag:
            scores = scores.masked_fill(prob_mask(L_Q, top_idx, scores.shape), -math.inf)
            context = torch.cumsum(v, dim=2)
        else:
            context = v.mean(dim=2, keepdim=True).expand(v.shape)

        A = torch.softmax((1.0 / math.sqrt(D)) * scores, dim=-1)
        if self.training:
            A = dropout(A, self.p, generator)
        v_top = torch.einsum("bhuk,bhkd->bhud", A, v)
        onehot = F.one_hot(top_idx, L_Q).to(v.dtype)  # [B, H, u, L_Q]
        updated = torch.einsum("bhul,bhud->bhld", onehot, v_top)
        selected = torch.einsum("bhul,bhud->bhld", onehot, torch.ones_like(v_top))
        context = torch.where(selected > 0, updated, context)
        return context.transpose(1, 2), None


class AttentionLayer(nn.Module):
    """The q / k / v projections to ``n_heads`` heads, the inner attention
    and the output projection."""

    def __init__(self, inner_attention: nn.Module, d_model: int, n_heads: int,
                 d_keys: int | None = None, d_values: int | None = None):
        super().__init__()
        d_keys = d_keys or d_model // n_heads
        d_values = d_values or d_model // n_heads
        self.n_heads = n_heads
        self.inner_attention = inner_attention
        self.query_projection = Linear(d_model, d_keys * n_heads)
        self.key_projection = Linear(d_model, d_keys * n_heads)
        self.value_projection = Linear(d_model, d_values * n_heads)
        self.out_projection = Linear(d_values * n_heads, d_model)

    def forward(self, queries, keys, values, attn_mask=None, generator=None, *, tau=None,
                delta=None):
        B, L, _ = queries.shape
        S, H = keys.shape[1], self.n_heads
        q = self.query_projection(queries).reshape(B, L, H, -1)
        k = self.key_projection(keys).reshape(B, S, H, -1)
        v = self.value_projection(values).reshape(B, S, H, -1)
        out, attn = self.inner_attention(q, k, v, attn_mask, generator, tau=tau, delta=delta)
        return self.out_projection(out.reshape(B, L, -1)), attn


class ReformerLayer(nn.Module):
    """LSH self-attention (``ops/lsh_attention.py``) behind a bias-free
    shared query / key projection ``qk_projection`` and a bias-free
    ``value_projection`` (so zero padding stays zero), then the biased
    ``out_projection``. The input is zero-padded at the end to a multiple of
    2 x ``bucket_size`` (the reference's ``fit_length``) and the output cut
    back. ``keys`` / ``values`` / ``attn_mask`` / ``tau`` / ``delta`` are
    not read (self-attention only), as in JAX.

    ``path`` names the flax module path the layer stands for ("/"-joined):
    the rotations are drawn on the CPU from a generator seeded with JAX's
    key, (bucket_size x 7919 + n_hashes + crc32(path)) mod 2^31, so every
    device and every call draws the same ones."""

    def __init__(self, d_model: int, n_heads: int, causal: bool = False, bucket_size: int = 4,
                 n_hashes: int = 4, path: str = ""):
        super().__init__()
        self.n_heads, self.dh = n_heads, d_model // n_heads
        self.causal, self.bucket_size, self.n_hashes = causal, bucket_size, n_hashes
        self.seed = (bucket_size * 7919 + n_hashes + zlib.crc32(path.encode())) % 2 ** 31
        self.qk_projection = Linear(d_model, self.dh * n_heads, bias=False)
        self.value_projection = Linear(d_model, self.dh * n_heads, bias=False)
        self.out_projection = Linear(self.dh * n_heads, d_model)

    def padded_length(self, N: int) -> int:
        chunk = 2 * self.bucket_size
        return N + (-N) % chunk

    def rotations(self, N: int, device) -> torch.Tensor:
        """The default rotations for N tokens: [n_hashes, dh, nb / 2], f32."""
        g = torch.Generator().manual_seed(self.seed)
        nb = n_buckets(self.padded_length(N), self.bucket_size)
        return torch.randn(self.n_hashes, self.dh, nb // 2, generator=g).to(device)

    def _heads(self, queries):
        """(qk, v) [B, H, L, dh] of the zero-padded input."""
        B, N, _ = queries.shape
        x = F.pad(queries, (0, 0, 0, self.padded_length(N) - N))
        return tuple(p(x).reshape(B, -1, self.n_heads, self.dh).transpose(1, 2)
                     for p in (self.qk_projection, self.value_projection))

    def buckets(self, queries, rotations=None) -> torch.Tensor:
        """The bucket ids of the padded tokens, [n_hashes, B, H, L]."""
        if rotations is None:
            rotations = self.rotations(queries.shape[1], queries.device)
        return lsh_buckets(self._heads(queries)[0], rotations)

    def forward(self, queries, keys=None, values=None, attn_mask=None, generator=None, *,
                tau=None, delta=None, rotations=None, buckets=None):
        B, N, _ = queries.shape
        if rotations is None:
            rotations = self.rotations(N, queries.device)
        qk, v = self._heads(queries)
        out = lsh_attention(qk, v, rotations, bucket_size=self.bucket_size,
                            causal=self.causal, buckets=buckets)
        out = out.transpose(1, 2).reshape(B, -1, self.n_heads * self.dh)[:, :N]
        return self.out_projection(out), None
