"""Transformer encoder and decoder stacks (port of
``medtsllm_tpu/ops/transformer.py``: ``EncoderLayer``, ``Encoder``,
``DecoderLayer``, ``Decoder`` and Informer's distilling ``ConvLayer``) and
``borrow``; flax's ``LayerNorm`` (in ``models/llm/transformer.py``, which
gpt2's blocks share) is imported from here too.

As in the JAX package, the point-wise conv FFN is a Dense over features
and the activation is relu or the exact-erf GELU (``F.gelu``'s default).
flax's LayerNorm has epsilon 1e-6 (torch's 1e-5), so the port has its own.
The attention modules of a layer, and the conv layers of an encoder, are
made by the model, whose flax scope holds their parameters; a layer holds
them by ``borrow``, so the state dict has the flax tree's keys. ``tau`` /
``delta`` (the Non-stationary Transformer's factors) pass to the
attentions as JAX passes them.

``ConvLayer`` keeps JAX's choices: its conv is flax's circular ``nn.Conv``
with a bias, and its BatchNorm always normalizes by the running averages
(flax's ``use_running_average=True``), in training too; they are buffers
(``norm.mean`` / ``norm.var``: flax's ``batch_stats``, which
``weights.from_flax`` takes as its second argument).

Where the reference oracle and the JAX package part (queue 3 of the
ROADMAP: ``test_transformer_encoder_oracle``), the port matches the JAX
package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.llm.transformer import LayerNorm, Linear, dropout
from .embed import CircularConv


def borrow(owner: nn.Module, name: str, module: nn.Module) -> None:
    """Hold ``module`` as ``owner.<name>`` without registering it: its
    parameters stay under the module that registered it (in the flax tree,
    the scope that made it), once, however many layers share it."""
    object.__setattr__(owner, name, module)


def activation(name: str):
    """relu, or the exact-erf GELU."""
    return F.relu if name == "relu" else F.gelu


class EncoderLayer(nn.Module):
    """Post-norm self-attention (the borrowed ``attention``), then the FFN
    ``conv2(act(conv1(x)))``; dropout ``p`` after the attention and each
    FFN Dense in training."""

    def __init__(self, attention: nn.Module, d_model: int, d_ff: int | None = None,
                 p: float = 0.1, activation_name: str = "relu"):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        borrow(self, "attention", attention)
        self.p, self.act = p, activation(activation_name)
        self.conv1 = Linear(d_model, d_ff)
        self.conv2 = Linear(d_ff, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def _drop(self, x, generator):
        return dropout(x, self.p, generator) if self.training else x

    def forward(self, x, attn_mask=None, generator=None, *, tau=None, delta=None):
        new_x, attn = self.attention(x, x, x, attn_mask, generator, tau=tau, delta=delta)
        x = self.norm1(x + self._drop(new_x, generator))
        y = self._drop(self.act(self.conv1(x)), generator)
        y = self._drop(self.conv2(y), generator)
        return self.norm2(x + y), attn


class Encoder(nn.Module):
    """The borrowed ``attn_layers`` in turn, then a LayerNorm (``norm``).
    With the borrowed distilling ``conv_layers`` (one fewer), each layer but
    the last is followed by its conv; ``delta`` reaches the first layer only
    and the last layer gets no mask, as in JAX."""

    def __init__(self, attn_layers, d_model: int, conv_layers=None):
        super().__init__()
        borrow(self, "attn_layers", tuple(attn_layers))
        borrow(self, "conv_layers", None if conv_layers is None else tuple(conv_layers))
        self.norm = LayerNorm(d_model)

    def forward(self, x, attn_mask=None, generator=None, *, tau=None, delta=None):
        attns = []
        if self.conv_layers is not None:
            for i, (layer, conv) in enumerate(zip(self.attn_layers, self.conv_layers)):
                x, attn = layer(x, attn_mask, generator, tau=tau, delta=delta if i == 0 else None)
                x = conv(x)
                attns.append(attn)
            x, attn = self.attn_layers[-1](x, None, generator, tau=tau)
            attns.append(attn)
        else:
            for layer in self.attn_layers:
                x, attn = layer(x, attn_mask, generator, tau=tau, delta=delta)
                attns.append(attn)
        return self.norm(x), attns


class DecoderLayer(nn.Module):
    """Post-norm self-attention (``tau`` only), cross-attention over
    ``cross`` (``tau`` and ``delta``) and the FFN, each borrowed attention
    as ``EncoderLayer`` holds it; dropout ``p`` in training."""

    def __init__(self, self_attention: nn.Module, cross_attention: nn.Module, d_model: int,
                 d_ff: int | None = None, p: float = 0.1, activation_name: str = "relu"):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        borrow(self, "self_attention", self_attention)
        borrow(self, "cross_attention", cross_attention)
        self.p, self.act = p, activation(activation_name)
        self.conv1 = Linear(d_model, d_ff)
        self.conv2 = Linear(d_ff, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def _drop(self, x, generator):
        return dropout(x, self.p, generator) if self.training else x

    def forward(self, x, cross, x_mask=None, cross_mask=None, generator=None, *, tau=None,
                delta=None):
        x = x + self._drop(self.self_attention(x, x, x, x_mask, generator, tau=tau)[0],
                           generator)
        x = self.norm1(x)
        x = x + self._drop(self.cross_attention(x, cross, cross, cross_mask, generator,
                                                tau=tau, delta=delta)[0], generator)
        x = self.norm2(x)
        y = self._drop(self.act(self.conv1(x)), generator)
        y = self._drop(self.conv2(y), generator)
        return self.norm3(x + y)


class Decoder(nn.Module):
    """The borrowed ``layers`` in turn, then a LayerNorm (``norm``) and a
    Dense to ``projection_dim`` (``projection``) when given."""

    def __init__(self, layers, d_model: int, projection_dim: int | None = None):
        super().__init__()
        borrow(self, "layers", tuple(layers))
        self.norm = LayerNorm(d_model)
        self.projection = None if projection_dim is None else Linear(d_model, projection_dim)

    def forward(self, x, cross, x_mask=None, cross_mask=None, generator=None, *, tau=None,
                delta=None):
        for layer in self.layers:
            x = layer(x, cross, x_mask, cross_mask, generator, tau=tau, delta=delta)
        x = self.norm(x)
        return x if self.projection is None else self.projection(x)


class RunningBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(use_running_average=True)`` over the last axis:
    (x - mean) * (rsqrt(var + eps) * scale) + bias with the running
    averages (buffers ``mean`` / ``var``, flax's ``batch_stats``; 0 and 1
    until loaded) in eval and in training alike."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x):
        return (x - self.mean) * (torch.rsqrt(self.var + self.eps) * self.scale) + self.bias


class ConvLayer(nn.Module):
    """Informer's distilling layer over [B, L, D]: the biased circular conv
    (k = 3, ``downConv``), ``RunningBatchNorm`` (``norm``), ELU, then a max
    pool of 3 with stride 2 and one -inf step of padding at each end:
    [B, (L - 1) // 2 + 1, D]."""

    def __init__(self, c_in: int):
        super().__init__()
        self.downConv = CircularConv(c_in, c_in, bias=True)
        self.norm = RunningBatchNorm(c_in)

    def forward(self, x):
        y = F.elu(self.norm(self.downConv(x)))
        y = F.pad(y, (0, 0, 1, 1), value=-math.inf)
        return y.unfold(1, 3, 2).amax(-1)
