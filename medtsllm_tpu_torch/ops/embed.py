"""Patch embedding (port of ``medtsllm_tpu/ops/embed.py``: TokenEmbedding,
patch_unfold, PatchEmbedding with ``pos_embed=False`` as MedTsLLM uses it)
and the dropout of the fusion layers.
"""

from __future__ import annotations

import torch
from torch import nn


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p and
    scale it by 1 / (1 - p); the mask is drawn from ``generator`` (on x's
    device), so a seeded trainer repeats its masks."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class TokenEmbedding(nn.Module):
    """Circular conv1d (k=3, no bias) over the time axis of [N, L, C].

    ``weight`` has Conv1d's layout [d_model, C, 3]. The conv is written as
    one matmul over the three circularly shifted rows, so it runs as a plain
    f32 GEMM on every device (cuDNN would take TF32 by default)."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_model, c_in, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, L, C]
        taps = torch.cat([x.roll(1, dims=1), x, x.roll(-1, dims=1)], dim=-1)
        w = self.weight.to(torch.promote_types(x.dtype, self.weight.dtype))
        return taps.to(w.dtype) @ w.permute(2, 1, 0).reshape(-1, w.shape[0])


def patch_unfold(x: torch.Tensor, patch_len: int, stride: int) -> torch.Tensor:
    """Replication-pad the series end by ``stride`` and unfold:
    [B, C, L] -> [B, C, (L - patch_len) // stride + 2, patch_len]."""
    xp = torch.cat([x, x[:, :, -1:].expand(-1, -1, stride)], dim=-1)
    return xp.unfold(-1, patch_len, stride)


class PatchEmbedding(nn.Module):
    """[B, C, L] -> [B * C, n_patches, d_model] (no positional term), with
    dropout ``p`` in training."""

    def __init__(self, d_model: int, patch_len: int, stride: int, p: float = 0.0):
        super().__init__()
        self.patch_len = patch_len
        self.stride = stride
        self.p = p
        self.value_embedding = TokenEmbedding(patch_len, d_model)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        B, C, _ = x.shape
        patches = patch_unfold(x, self.patch_len, self.stride)
        out = self.value_embedding(patches.reshape(B * C, -1, self.patch_len))
        return dropout(out, self.p, generator) if self.training else out
