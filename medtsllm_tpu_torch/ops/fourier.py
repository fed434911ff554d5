"""Frequency-domain attention (port of ``medtsllm_tpu/ops/fourier.py``:
``get_frequency_modes``, ``FourierBlock`` and ``FourierCrossAttention``).

Spectra are (re, im) pairs (``ops/dft.py``); the selected modes are a
static gather (a buffer of indices fixed at construction), the per-mode
complex weights one einsum, the write-back a static pad or index copy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .dft import complex_einsum_ri, irfft_ri, rfft_ri


def get_frequency_modes(seq_len: int, modes: int = 64,
                        mode_select_method: str = "random") -> list[int]:
    """The frequency modes kept: ``modes`` (at most seq_len // 2) drawn by
    the global numpy RNG (seeded by the trainer before the datasets) under
    "random", else the lowest; sorted."""
    modes = min(modes, seq_len // 2)
    if mode_select_method == "random":
        index = list(range(0, seq_len // 2))
        np.random.shuffle(index)
        index = index[:modes]
    else:
        index = list(range(0, modes))
    index.sort()
    return index


def _spectral_weights(module: nn.Module, shape: tuple) -> None:
    """``weights1`` / ``weights2``: the real and imaginary parts of the
    per-mode complex weights (drawn scale * U[0, 1), ``weights.py``)."""
    module.weights1 = nn.Parameter(torch.empty(shape))
    module.weights2 = nn.Parameter(torch.empty(shape))


class FourierBlock(nn.Module):
    """rFFT -> a complex weight per selected mode -> irFFT, in place of
    self-attention (only q is read). q [B, L, H, E] -> ([B, H, E, L], None);
    mode i's output lands in bin i (the selected modes pack into the lowest
    bins, as upstream FEDformer's do)."""

    def __init__(self, in_channels: int, out_channels: int, seq_len: int, index: tuple,
                 n_heads: int = 8):
        super().__init__()
        self.in_channels, self.out_channels, self.seq_len = in_channels, out_channels, seq_len
        self.n_modes = len(index)
        self.register_buffer("index", torch.tensor(list(index), dtype=torch.int64),
                             persistent=False)
        _spectral_weights(self, (n_heads, in_channels // n_heads, out_channels // n_heads,
                                 len(index)))

    def forward(self, q, k, v, attn_mask=None, generator=None):
        x = q.permute(0, 2, 3, 1)  # [B, H, E, L]
        xre, xim = rfft_ri(x)
        ore, oim = complex_einsum_ri("bhim,hiom->bhom", xre[..., self.index],
                                     xim[..., self.index], self.weights1.float(),
                                     self.weights2.float())
        pad = (0, self.seq_len // 2 + 1 - self.n_modes)
        out = irfft_ri(torch.nn.functional.pad(ore, pad), torch.nn.functional.pad(oim, pad),
                       n=self.seq_len)
        return out.to(q.dtype), None


class FourierCrossAttention(nn.Module):
    """The q and k spectra at their selected modes, the scores q . k (no
    conjugate) through tanh (or a softmax of their magnitude), the values'
    spectra mixed by them and by the complex weights, written back at the
    q modes and inverted. q [B, L, H, E] -> ([B, H, E, L], None)."""

    def __init__(self, in_channels: int, out_channels: int, seq_len_q: int, seq_len_kv: int,
                 index_q: tuple, index_kv: tuple, activation: str = "tanh",
                 num_heads: int = 8):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.seq_len_q, self.num_heads, self.activation = seq_len_q, num_heads, activation
        self.register_buffer("index_q", torch.tensor(list(index_q), dtype=torch.int64),
                             persistent=False)
        self.register_buffer("index_kv", torch.tensor(list(index_kv), dtype=torch.int64),
                             persistent=False)
        _spectral_weights(self, (num_heads, in_channels // num_heads,
                                 out_channels // num_heads, len(index_q)))

    def forward(self, q, k, v, attn_mask=None, generator=None):
        B, L, H, E = q.shape
        qre, qim = (t[..., self.index_q] for t in rfft_ri(q.permute(0, 2, 3, 1)))
        kre, kim = (t[..., self.index_kv] for t in rfft_ri(k.permute(0, 2, 3, 1)))
        sre, sim = complex_einsum_ri("bhex,bhey->bhxy", qre, qim, kre, kim)
        sre, sim = frequency_activation(sre, sim, self.activation)
        vre, vim = complex_einsum_ri("bhxy,bhey->bhex", sre, sim, kre, kim)
        ore, oim = complex_einsum_ri("bhex,heox->bhox", vre, vim, self.weights1.float(),
                                     self.weights2.float())
        F = self.seq_len_q // 2 + 1
        Eo = self.out_channels // self.num_heads
        denom = self.in_channels * self.out_channels
        zeros = torch.zeros(B, H, Eo, F, dtype=torch.float32, device=q.device)
        out = irfft_ri(zeros.index_copy(-1, self.index_q, ore) / denom,
                       zeros.index_copy(-1, self.index_q, oim) / denom, n=L)
        return out.to(q.dtype), None


def frequency_activation(sre, sim, activation: str):
    """The frequency scores' activation: tanh of each part, or the softmax
    of the magnitude (a real result)."""
    if activation == "tanh":
        return torch.tanh(sre), torch.tanh(sim)
    if activation == "softmax":
        a = torch.sqrt(sre ** 2 + sim ** 2)
        a = torch.exp(a - a.amax(dim=-1, keepdim=True))
        return a / a.sum(dim=-1, keepdim=True), torch.zeros_like(sre)
    raise ValueError(f"{activation} activation is not implemented")
