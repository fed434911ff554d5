"""The Autoformer encoder and decoder with progressive decomposition (port
of ``medtsllm_tpu/ops/autoformer.py``: ``MyLayerNorm``, the encoder and
decoder layers and stacks).

Each layer's attention is borrowed from the model, which registers it
(``ops/transformer.py::borrow``); the FFN is two bias-free Denses with
relu or the exact-erf GELU between; the decoder's trend projection is a
bias-free circular conv (k = 3).
"""

from __future__ import annotations

from torch import nn

from ..models.llm.transformer import Linear
from .decomp import series_decomp
from .embed import CircularConv, dropout
from .transformer import LayerNorm, activation, borrow


class MyLayerNorm(nn.Module):
    """The de-biased layernorm of a seasonal part: LayerNorm (``layernorm``),
    then less its mean over the time axis."""

    def __init__(self, d_model: int):
        super().__init__()
        self.layernorm = LayerNorm(d_model)

    def forward(self, x):
        x_hat = self.layernorm(x)
        return x_hat - x_hat.mean(dim=1, keepdim=True)


class _Layer(nn.Module):
    """The FFN and dropout an Autoformer layer shares."""

    def __init__(self, d_model: int, d_ff: int | None, moving_avg: int, p: float,
                 activation_name: str):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.moving_avg, self.p, self.act = moving_avg, p, activation(activation_name)
        self.conv1 = Linear(d_model, d_ff, bias=False)
        self.conv2 = Linear(d_ff, d_model, bias=False)

    def _drop(self, x, generator):
        return dropout(x, self.p, generator) if self.training else x

    def _ffn(self, x, generator):
        y = self._drop(self.act(self.conv1(x)), generator)
        return self._drop(self.conv2(y), generator)


class AutoformerEncoderLayer(_Layer):
    """Attention, decomposition, FFN, decomposition: the seasonal part."""

    def __init__(self, attention: nn.Module, d_model: int, d_ff: int | None = None,
                 moving_avg: int = 25, p: float = 0.1, activation_name: str = "relu"):
        super().__init__(d_model, d_ff, moving_avg, p, activation_name)
        borrow(self, "attention", attention)

    def forward(self, x, attn_mask=None, generator=None):
        new_x, attn = self.attention(x, x, x, attn_mask, generator)
        x, _ = series_decomp(x + self._drop(new_x, generator), self.moving_avg)
        res, _ = series_decomp(x + self._ffn(x, generator), self.moving_avg)
        return res, attn


class AutoformerEncoder(nn.Module):
    """The borrowed layers in turn, then ``MyLayerNorm`` (``norm``)."""

    def __init__(self, attn_layers, d_model: int):
        super().__init__()
        borrow(self, "attn_layers", tuple(attn_layers))
        self.norm = MyLayerNorm(d_model)

    def forward(self, x, attn_mask=None, generator=None):
        attns = []
        for layer in self.attn_layers:
            x, attn = layer(x, attn_mask, generator)
            attns.append(attn)
        return self.norm(x), attns


class AutoformerDecoderLayer(_Layer):
    """Self-attention, cross-attention and the FFN, each followed by a
    decomposition; the three trends summed and projected to ``c_out`` by a
    circular conv (``projection``). Returns (seasonal, residual trend)."""

    def __init__(self, self_attention: nn.Module, cross_attention: nn.Module, d_model: int,
                 c_out: int, d_ff: int | None = None, moving_avg: int = 25, p: float = 0.1,
                 activation_name: str = "relu"):
        super().__init__(d_model, d_ff, moving_avg, p, activation_name)
        borrow(self, "self_attention", self_attention)
        borrow(self, "cross_attention", cross_attention)
        self.projection = CircularConv(d_model, c_out)

    def forward(self, x, cross, x_mask=None, cross_mask=None, generator=None):
        x = x + self._drop(self.self_attention(x, x, x, x_mask, generator)[0], generator)
        x, trend1 = series_decomp(x, self.moving_avg)
        x = x + self._drop(self.cross_attention(x, cross, cross, cross_mask, generator)[0],
                           generator)
        x, trend2 = series_decomp(x, self.moving_avg)
        x, trend3 = series_decomp(x + self._ffn(x, generator), self.moving_avg)
        return x, self.projection(trend1 + trend2 + trend3)


class AutoformerDecoder(nn.Module):
    """The borrowed layers in turn, each adding its residual trend to
    ``trend``; then ``MyLayerNorm`` (``norm``) and a Dense to ``c_out``
    (``projection``) on the seasonal part. Returns (seasonal, trend)."""

    def __init__(self, layers, d_model: int, c_out: int):
        super().__init__()
        borrow(self, "layers", tuple(layers))
        self.norm = MyLayerNorm(d_model)
        self.projection = Linear(d_model, c_out)

    def forward(self, x, cross, x_mask=None, cross_mask=None, trend=None, generator=None):
        for layer in self.layers:
            x, residual_trend = layer(x, cross, x_mask, cross_mask, generator)
            trend = trend + residual_trend
        return self.projection(self.norm(x)), trend
