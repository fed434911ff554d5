"""FEDformer (port of ``medtsllm_tpu/models/fedformer.py``): the
frequency-enhanced decomposed transformer, ``version = "fourier"``
(``FourierBlock`` / ``FourierCrossAttention``) or ``"Wavelets"``
(``MultiWaveletTransform`` / ``MultiWaveletCross``), f32 only.

As in the reference, one self-attention block is shared by every encoder
layer, one by every decoder layer and one cross-attention block by every
decoder layer: each is registered once, under its flax name
(``FourierBlock_0``, ``FourierBlock_1``, ``FourierCrossAttention_0``, or
``MultiWaveletTransform_{0,1}``, ``MultiWaveletCross_0``), and the layers
borrow it. The decoder's blocks exist for forecasting only (the other
tasks run the encoder and a head), as JAX's lazily built tree has them.
The frequency modes of ``mode_select = "random"`` are drawn from the
global numpy RNG here, four times in JAX's order, so a trainer seeded as
JAX's (numpy, then the datasets, then the model) draws JAX's modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.autocorr import AutoCorrelationLayer
from ..ops.autoformer import (AutoformerDecoder, AutoformerDecoderLayer, AutoformerEncoder,
                              AutoformerEncoderLayer)
from ..ops.decomp import series_decomp
from ..ops.embed import DataEmbedding, dropout
from ..ops.fourier import FourierBlock, FourierCrossAttention, get_frequency_modes
from ..ops.wavelets import MultiWaveletCross, MultiWaveletTransform
from .dlinear import SUPPORTED_TASKS
from .llm.transformer import Linear


class FEDformer(nn.Module):
    supported_tasks = SUPPORTED_TASKS

    def __init__(self, *, task, seq_len, label_len, pred_len, version, modes, index_enc,
                 index_dec, index_cross_q, index_cross_kv, e_layers, d_layers, d_model,
                 n_heads, d_ff, moving_avg_kernel, activation, enc_in, c_out, num_class,
                 dropout=0.0, seg_mode=None):
        super().__init__()
        self.task, self.seq_len, self.pred_len = task, seq_len, pred_len
        self.label_len = label_len
        self.index_enc, self.index_dec = tuple(index_enc), tuple(index_dec)
        self.index_cross_q, self.index_cross_kv = tuple(index_cross_q), tuple(index_cross_kv)
        self.num_class, self.p, self.seg_mode = num_class, dropout, seg_mode
        self.moving_avg_kernel = moving_avg_kernel
        forecast = task == "forecasting"
        dec_len = seq_len // 2 + pred_len
        if version == "Wavelets":
            self.MultiWaveletTransform_0 = enc_self = MultiWaveletTransform(
                ich=d_model, L=1, base="legendre")
            if forecast:
                self.MultiWaveletTransform_1 = dec_self = MultiWaveletTransform(
                    ich=d_model, L=1, base="legendre")
                self.MultiWaveletCross_0 = dec_cross = MultiWaveletCross(
                    in_channels=d_model, out_channels=d_model, seq_len_q=dec_len,
                    seq_len_kv=seq_len, modes=modes, ich=d_model, base="legendre",
                    activation="tanh")
        else:
            self.FourierBlock_0 = enc_self = FourierBlock(d_model, d_model, seq_len,
                                                          self.index_enc, n_heads)
            if forecast:
                self.FourierBlock_1 = dec_self = FourierBlock(d_model, d_model, dec_len,
                                                              self.index_dec, n_heads)
                self.FourierCrossAttention_0 = dec_cross = FourierCrossAttention(
                    d_model, d_model, dec_len, seq_len, self.index_cross_q,
                    self.index_cross_kv, num_heads=n_heads)
        self.enc_embedding = DataEmbedding(enc_in, d_model, "timeF", "s", dropout)
        enc_layers = []
        for i in range(e_layers):
            attn = AutoCorrelationLayer(enc_self, d_model, n_heads)
            setattr(self, f"enc_attn_{i}", attn)
            layer = AutoformerEncoderLayer(attn, d_model, d_ff, moving_avg=moving_avg_kernel,
                                           p=dropout, activation_name=activation)
            setattr(self, f"enc_layer_{i}", layer)
            enc_layers.append(layer)
        self.encoder = AutoformerEncoder(enc_layers, d_model)
        if forecast:
            self.dec_embedding = DataEmbedding(enc_in, d_model, "timeF", "s", dropout)
            dec_layers = []
            for i in range(d_layers):
                self_attn = AutoCorrelationLayer(dec_self, d_model, n_heads)
                cross_attn = AutoCorrelationLayer(dec_cross, d_model, n_heads)
                setattr(self, f"dec_self_{i}", self_attn)
                setattr(self, f"dec_cross_{i}", cross_attn)
                layer = AutoformerDecoderLayer(self_attn, cross_attn, d_model, c_out, d_ff,
                                               moving_avg=moving_avg_kernel, p=dropout,
                                               activation_name=activation)
                setattr(self, f"dec_layer_{i}", layer)
                dec_layers.append(layer)
            self.decoder = AutoformerDecoder(dec_layers, d_model, c_out)
        elif task in ("anomaly_detection", "reconstruction", "imputation"):
            self.projection = Linear(d_model, c_out)
        elif task == "classification":
            self.projection = Linear(d_model * seq_len, num_class)
        elif task == "semantic_segmentation":
            self.projection = Linear(d_model * seq_len,
                                     pred_len * num_class if num_class > 2 else pred_len)
        elif task == "segmentation":
            self.projection = Linear(d_model * seq_len, seq_len)
        else:
            raise ValueError(f"Invalid task for FEDformer: {task}")

    @classmethod
    def from_config(cls, config, dataset):
        mc = config.models.fedformer
        task = config.task
        seq_len, pred_len = config.history_len, config.pred_len
        dec_len = seq_len // 2 + pred_len
        if task == "forecasting" and mc.label_len != seq_len // 2:
            # the decoder's frequency blocks are sized for seq // 2 + pred
            # while label_len + pred tokens enter it
            raise ValueError(f"fedformer forecasting requires label_len == history_len//2 "
                             f"(got {mc.label_len} != {seq_len // 2})")
        modes, select = mc.modes, mc.mode_select
        return cls(
            task=task, seq_len=seq_len, label_len=mc.label_len, pred_len=pred_len,
            version=mc.version, modes=modes,
            index_enc=get_frequency_modes(seq_len, modes, select),
            index_dec=get_frequency_modes(dec_len, modes, select),
            index_cross_q=get_frequency_modes(dec_len, modes, select),
            index_cross_kv=get_frequency_modes(seq_len, modes, select),
            e_layers=mc.e_layers, d_layers=mc.d_layers, d_model=mc.d_model,
            n_heads=mc.n_heads, d_ff=mc.d_ff, moving_avg_kernel=mc.moving_avg,
            activation=mc.activation, enc_in=dataset.n_features, c_out=dataset.n_features,
            num_class=(dataset.n_classes
                       if task in ("classification", "semantic_segmentation") else 0),
            dropout=config.training.dropout,
            seg_mode=config.tasks.segmentation.mode if task == "segmentation" else None)

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        x_enc = inputs["x_enc"].float()
        enc_out = self.enc_embedding(x_enc, None, generator)
        enc_out, _ = self.encoder(enc_out, generator=generator)
        if self.task == "forecasting":
            # the decomposition's initial seasonal and trend parts
            mean = x_enc.mean(dim=1, keepdim=True).expand(-1, self.pred_len, -1)
            seasonal_init, trend_init = series_decomp(x_enc, self.moving_avg_kernel)
            trend_init = torch.cat([trend_init[:, -self.label_len:], mean], dim=1)
            seasonal_init = F.pad(seasonal_init[:, -self.label_len:], (0, 0, 0, self.pred_len))
            dec_out = self.dec_embedding(seasonal_init, None, generator)
            seasonal, trend = self.decoder(dec_out, enc_out, trend=trend_init,
                                           generator=generator)
            return (trend + seasonal)[:, -self.pred_len:]
        if self.task in ("anomaly_detection", "reconstruction", "imputation"):
            return self.projection(enc_out)
        out = F.gelu(enc_out)
        if self.task == "classification":
            if self.training:
                out = dropout(out, self.p, generator)
            return self.projection(out.reshape(out.shape[0], -1))
        out = self.projection(out.reshape(out.shape[0], -1))
        if self.task == "semantic_segmentation":
            if self.num_class > 2:
                out = out.reshape(out.shape[0], self.pred_len, self.num_class)
                return out if self.training else torch.softmax(out, dim=-1)
            return out if self.training else torch.sigmoid(out)
        if not self.training and self.seg_mode == "boundary-prediction":
            out = torch.sigmoid(out)
        return out
