"""Transformer encoder (port of ``medtsllm_tpu/ops/transformer.py``:
``EncoderLayer`` and ``Encoder``) and ``borrow``; flax's ``LayerNorm`` (in
``models/llm/transformer.py``, which gpt2's blocks share) is imported from here too.

As in the JAX package, the point-wise conv FFN is a Dense over features
and the activation is relu or the exact-erf GELU (``F.gelu``'s default).
flax's LayerNorm has epsilon 1e-6 (torch's 1e-5), so the port has its own.
The attention module of a layer is made by the model, whose flax scope
holds its parameters; a layer holds it by ``borrow``, so the state dict
has the flax tree's keys. ``DecoderLayer``, ``Decoder`` and the distilling
``ConvLayer`` are reached by no ported model.

Where the reference oracle and the JAX package part (queue 3 of the
ROADMAP: ``test_transformer_encoder_oracle``), the port matches the JAX
package.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..models.llm.transformer import LayerNorm, Linear, dropout


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

    def forward(self, x, attn_mask=None, generator=None):
        new_x, attn = self.attention(x, x, x, attn_mask, generator)
        x = self.norm1(x + self._drop(new_x, generator))
        y = self._drop(self.act(self.conv1(x)), generator)
        y = self._drop(self.conv2(y), generator)
        return self.norm2(x + y), attn


class Encoder(nn.Module):
    """The borrowed ``attn_layers`` in turn, then a LayerNorm (``norm``)."""

    def __init__(self, attn_layers, d_model: int):
        super().__init__()
        borrow(self, "attn_layers", tuple(attn_layers))
        self.norm = LayerNorm(d_model)

    def forward(self, x, attn_mask=None, generator=None):
        attns = []
        for layer in self.attn_layers:
            x, attn = layer(x, attn_mask, generator)
            attns.append(attn)
        return self.norm(x), attns
