"""LSH (Reformer-style) self-attention (port of
``medtsllm_tpu/ops/lsh_attention.py``), in two parts: ``lsh_buckets`` hashes
the tokens, ``lsh_attention`` attends within the buckets.

Per hash round r, a rotation R_r [dh, nb / 2] gives bucket(t) =
argmax([x R_r | -x R_r]) (the first index on ties, in both frameworks);
the tokens are stable-sorted by bucket (positions in order inside one),
cut into chunks of 2 x ``bucket_size``, and each chunk attends to itself
and to the chunk before it (chunk 0 to the last: the causal mask kills that
wrap, the non-causal form keeps it). The keys are the shared q / k rows
normalized by rsqrt(sum of squares + 1e-12), which stays finite at the
zero padding tokens. A token's score with itself is -5e4 (it attends to
itself only when no other token survives the masks, which are -1e30); the
rounds combine by a softmax over their log-sum-exp masses.

The rotations are an argument: JAX draws them inside the function from
``jax.random``, which the port cannot reproduce (``ReformerLayer`` draws
its own). The buckets are an argument too, so a caller can hold the
attention on one device against another on the same buckets: an ulp in
x R_r can flip an argmax between two devices.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
SELF_MASK = -5e4


def n_buckets(N: int, bucket_size: int) -> int:
    """The buckets of N tokens (N a multiple of 2 x bucket_size): two a
    chunk, at least 2."""
    return max(2, 2 * (N // (2 * bucket_size)))


def lsh_buckets(qk: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """qk [B, H, N, dh], rotations [n_hashes, dh, nb / 2] -> the bucket ids
    [n_hashes, B, H, N] (int64), computed in f32."""
    h = torch.einsum("bhnd,rdk->rbhnk", qk.float(), rotations.float())
    return torch.cat([h, -h], dim=-1).argmax(-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, d] at idx [B, H, N] along N."""
    return torch.gather(x, 2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def lsh_attention(qk: torch.Tensor, v: torch.Tensor, rotations: torch.Tensor,
                  bucket_size: int = 4, causal: bool = False,
                  buckets: torch.Tensor | None = None) -> torch.Tensor:
    """qk, v [B, H, N, dh] (shared query / key rows) -> [B, H, N, dh].

    N must be a multiple of 2 x ``bucket_size`` (``ReformerLayer`` pads);
    ``rotations`` [n_hashes, dh, n_buckets(N) / 2]; ``buckets`` [n_hashes,
    B, H, N] replaces ``lsh_buckets(qk, rotations)`` when given."""
    B, H, N, dh = qk.shape
    chunk = 2 * bucket_size
    if N % chunk:
        raise ValueError(f"lsh_attention: N {N} is not a multiple of 2 x bucket_size {chunk}")
    n_chunks = N // chunk
    if buckets is None:
        buckets = lsh_buckets(qk, rotations)
    scale = 1.0 / math.sqrt(dh)

    outs, masses = [], []
    for r in range(buckets.shape[0]):
        order = torch.argsort(buckets[r], dim=-1, stable=True)
        inv = torch.argsort(order, dim=-1)
        qs = _take(qk, order).reshape(B, H, n_chunks, chunk, dh)
        vs = _take(v, order).reshape(B, H, n_chunks, chunk, dh)
        ps = order.reshape(B, H, n_chunks, chunk)  # the sorted positions

        ks = torch.cat([qs.roll(1, dims=2), qs], dim=3)  # [B, H, C, 2c, dh]
        vv = torch.cat([vs.roll(1, dims=2), vs], dim=3)
        pk = torch.cat([ps.roll(1, dims=2), ps], dim=3)  # [B, H, C, 2c]
        ksf = ks.float()
        ks = (ksf * torch.rsqrt(ksf.square().sum(-1, keepdim=True) + 1e-12)).to(ks.dtype)
        s = torch.einsum("bhcqd,bhckd->bhcqk", qs, ks).float() * scale
        same = ps[..., :, None] == pk[..., None, :]
        s = torch.where(same, torch.full_like(s, SELF_MASK), s)
        if causal:
            s = torch.where(ps[..., :, None] >= pk[..., None, :], s, torch.full_like(s, NEG_INF))

        m = s.amax(-1, keepdim=True)
        p_ = torch.exp(s - m)
        denom = p_.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bhcqk,bhckd->bhcqd", (p_ / denom).to(vv.dtype), vv)
        mass = (m + torch.log(denom))[..., 0]  # [B, H, C, c]
        outs.append(_take(o.reshape(B, H, N, dh), inv))
        masses.append(torch.gather(mass.reshape(B, H, N), -1, inv))

    w = torch.softmax(torch.stack(masses), dim=0)[..., None]  # the rounds' weights
    return (torch.stack(outs) * w.to(outs[0].dtype)).sum(0)
