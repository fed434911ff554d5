"""Embeddings (port of ``medtsllm_tpu/ops/embed.py``): the sincos
``positional_embedding``, ``TokenEmbedding``'s circular conv, the calendar
embeddings (``FixedEmbedding``, ``TemporalEmbedding``,
``TimeFeatureEmbedding``), ``DataEmbedding`` with its ``_wo_pos`` and
``_wo_time`` forms, ``patch_unfold`` and ``PatchEmbedding`` (with
``pos_embed=False``, as MedTsLLM uses it); ``dropout`` (every layer's) lives
in ``models/llm/transformer.py`` beside flax's Dense and LayerNorm.

Where JAX builds a submodule only when its input is given (the temporal
embedding of ``DataEmbedding`` under an ``x_mark``), the port builds it
when the constructor says so (``temporal``), so the state dict has the
flax tree's keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import device_constant
from ..models.llm.transformer import Linear, dropout


def positional_embedding(max_len: int, d_model: int) -> np.ndarray:
    """The fixed sincos table [max_len, d_model] (float64 math, f32)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : d_model // 2]
    return pe.astype(np.float32)


def positions(L: int, d_model: int, device: torch.device) -> torch.Tensor:
    """``positional_embedding(L, d_model)`` on ``device``, made once."""
    return device_constant(("pe", L, d_model), lambda: positional_embedding(L, d_model),
                           device)


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


class CircularConv(TokenEmbedding):
    """flax's ``nn.Conv`` (k = 3, circular padding) over the time axis:
    ``TokenEmbedding``'s conv plus a ``bias`` when asked, drawn with the
    flax Conv's default init (lecun normal kernel, zero bias;
    ``weights.init_random_``)."""

    def __init__(self, c_in: int, d_model: int, bias: bool = False):
        super().__init__(c_in, d_model)
        self.bias = nn.Parameter(torch.zeros(d_model)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y if self.bias is None else y + self.bias.to(y.dtype)


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


class FixedEmbedding(nn.Module):
    """A non-trainable sinusoidal lookup table of ``c_in`` rows."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.register_buffer("table", torch.tensor(positional_embedding(c_in, d_model)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.table[x]


class Embed(nn.Module):
    """flax ``nn.Embed``: a trainable table under the name ``embedding``."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(c_in, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding[x]


# the calendar fields of an x_mark row, in order, with their table sizes
CALENDAR = (("month_embed", 13), ("day_embed", 32), ("weekday_embed", 7), ("hour_embed", 24),
            ("minute_embed", 4))
# freq -> the real-valued time features of TimeFeatureEmbedding's input
# (the reference's freq_map)
TIME_FEATURES = {"h": 4, "t": 5, "s": 6, "m": 1, "a": 1, "w": 2, "d": 3, "b": 3}


class TemporalEmbedding(nn.Module):
    """The sum of the month / day / weekday / hour (and, at ``freq`` "t",
    minute) embeddings of integer calendar features [B, L, >= 4]: fixed
    sincos tables, or trainable ones unless ``embed_type`` is "fixed"."""

    def __init__(self, d_model: int, embed_type: str = "fixed", freq: str = "h"):
        super().__init__()
        self.fields = CALENDAR if freq == "t" else CALENDAR[:4]
        table = FixedEmbedding if embed_type == "fixed" else Embed
        for name, size in self.fields:
            setattr(self, name, table(size, d_model))

    def forward(self, x_mark: torch.Tensor) -> torch.Tensor:
        x = x_mark.long()
        out = 0
        for i, (name, _) in enumerate(self.fields):
            out = out + getattr(self, name)(x[:, :, i])
        return out


class TimeFeatureEmbedding(nn.Module):
    """A bias-free Dense of the real-valued time features (``Dense_0``)."""

    def __init__(self, d_model: int, freq: str = "h"):
        super().__init__()
        self.Dense_0 = Linear(TIME_FEATURES[freq], d_model, bias=False)

    def forward(self, x_mark: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x_mark)


class DataEmbedding(nn.Module):
    """[B, L, c_in] -> [B, L, d_model]: the value conv embedding, the sincos
    positions (``use_pos``) and, with ``temporal``, the embedding of an
    ``x_mark`` (``TimeFeatureEmbedding`` under ``embed_type`` "timeF", else
    ``TemporalEmbedding``); dropout ``p`` in training."""

    def __init__(self, c_in: int, d_model: int, embed_type: str = "fixed", freq: str = "h",
                 p: float = 0.1, use_pos: bool = True, temporal: bool = False):
        super().__init__()
        self.p, self.use_pos = p, use_pos
        self.value_embedding = TokenEmbedding(c_in, d_model)
        if temporal:
            self.temporal_embedding = (TimeFeatureEmbedding(d_model, freq)
                                       if embed_type == "timeF"
                                       else TemporalEmbedding(d_model, embed_type, freq))

    def forward(self, x: torch.Tensor, x_mark: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        out = self.value_embedding(x)
        if self.use_pos:
            out = out + positions(x.shape[1], out.shape[-1], x.device)
        if x_mark is not None:
            out = out + self.temporal_embedding(x_mark)
        return dropout(out, self.p, generator) if self.training else out


class DataEmbedding_wo_pos(DataEmbedding):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, use_pos=False)


class DataEmbedding_wo_time(DataEmbedding):
    """The value conv embedding and the positions only."""

    def __init__(self, c_in: int, d_model: int, p: float = 0.1):
        super().__init__(c_in, d_model, p=p)
