"""Patch embedding (port of ``medtsllm_tpu/ops/embed.py``: TokenEmbedding,
patch_unfold, PatchEmbedding with ``pos_embed=False`` as MedTsLLM uses it).
"""

from __future__ import annotations

import torch
from torch import nn


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
    """[B, C, L] -> [B * C, n_patches, d_model] (no positional term)."""

    def __init__(self, d_model: int, patch_len: int, stride: int):
        super().__init__()
        self.patch_len = patch_len
        self.stride = stride
        self.value_embedding = TokenEmbedding(patch_len, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, _ = x.shape
        patches = patch_unfold(x, self.patch_len, self.stride)
        return self.value_embedding(patches.reshape(B * C, -1, self.patch_len))
