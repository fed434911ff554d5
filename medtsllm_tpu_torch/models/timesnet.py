"""TimesNet (port of ``medtsllm_tpu/models/timesnet.py``): ``TimesBlock``s
that fold the series by its top-k periods and run inception 2-D convs on
the folded images (``ops/inception.py``), and each task's head.

The periods stay device tensors (``fft_for_period``): no forward reads
them back, so the eval and train steps are captured as one CUDA graph
each. As in JAX, a 2T buffer carries the first conv's outputs (its padded
rows included) to the second, cropped to T after it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embed import DataEmbedding, dropout
from ..ops.inception import InceptionBlockV1, fft_for_period, fold_conv_valid_mask
from ..ops.revin import masked_window_norm
from ..ops.transformer import LayerNorm
from .dlinear import SUPPORTED_TASKS
from .llm.transformer import Linear
from .patchtst import window_norm


class TimesBlock(nn.Module):
    """For each of the top-k periods: fold, inception conv, GELU, inception
    conv, unfold; the k results mixed by the softmax of their amplitudes;
    plus the residual. [B, T, d_model] -> [B, T, d_model]."""

    def __init__(self, d_model: int, d_ff: int, num_kernels: int, top_k: int):
        super().__init__()
        self.top_k = top_k
        self.conv1 = InceptionBlockV1(d_model, d_ff, num_kernels)
        self.conv2 = InceptionBlockV1(d_ff, d_model, num_kernels)

    def forward(self, x):
        B, T, N = x.shape
        periods, period_weight = fft_for_period(x, self.top_k)
        xbuf = torch.cat([x, torch.zeros_like(x)], dim=1)  # [B, 2T, N]
        res = []
        for i in range(self.top_k):
            mid = F.gelu(self.conv1(xbuf, periods[i], seq_len=T, out_len=2 * T))
            valid = fold_conv_valid_mask(2 * T, T, periods[i])[None, :, None]
            mid = torch.where(valid, mid, torch.zeros((), dtype=mid.dtype, device=mid.device))
            res.append(self.conv2(mid, periods[i], seq_len=T, out_len=T))
        w = torch.softmax(period_weight.to(x.dtype), dim=1)  # [B, k]
        return (torch.stack(res, dim=-1) * w[:, None, None, :]).sum(dim=-1) + x


class TimesNet(nn.Module):
    supported_tasks = SUPPORTED_TASKS

    def __init__(self, *, task, seq_len, pred_len, enc_in, c_out, num_class, d_model, d_ff,
                 e_layers, top_k, num_kernels, dropout=0.0, seg_mode=None):
        super().__init__()
        self.task, self.seq_len, self.pred_len = task, seq_len, pred_len
        self.num_class, self.e_layers, self.seg_mode = num_class, e_layers, seg_mode
        self.p = dropout
        self.enc_embedding = DataEmbedding(enc_in, d_model, "timeF", "s", dropout)
        if task == "forecasting":
            # align the time axis to history + prediction before the blocks
            self.predict_linear = Linear(seq_len, seq_len + pred_len)
        for i in range(e_layers):
            setattr(self, f"block_{i}", TimesBlock(d_model, d_ff, num_kernels, top_k))
        self.layer_norm = LayerNorm(d_model)  # shared by every block
        if task in ("forecasting", "reconstruction", "anomaly_detection", "imputation"):
            self.projection = Linear(d_model, c_out)
        elif task == "classification":
            self.projection = Linear(d_model * seq_len, num_class)
        elif task in ("semantic_segmentation", "segmentation"):
            self.projection = Linear(d_model, num_class if task == "semantic_segmentation"
                                     and num_class > 2 else 1)
        else:
            raise ValueError(f"Invalid task for TimesNet: {task}")

    @classmethod
    def from_config(cls, config, dataset):
        mc = config.models.timesnet
        task = config.task
        if task != "forecasting" and config.pred_len != config.history_len:
            raise ValueError(f"{task} requires pred_len == history_len")
        return cls(
            task=task, seq_len=config.history_len,
            pred_len=config.pred_len if task == "forecasting" else 0,
            enc_in=dataset.n_features, c_out=dataset.n_features,
            num_class=(dataset.n_classes
                       if task in ("classification", "semantic_segmentation") else 0),
            d_model=mc.d_model, d_ff=mc.d_ff, e_layers=mc.e_layers, top_k=mc.top_k,
            num_kernels=mc.num_kernels, dropout=config.training.dropout,
            seg_mode=config.tasks.segmentation.mode if task == "segmentation" else None)

    def _backbone(self, x, generator):
        enc = self.enc_embedding(x, None, generator)
        if self.task == "forecasting":
            enc = self.predict_linear(enc.transpose(1, 2)).transpose(1, 2)
        for i in range(self.e_layers):
            enc = self.layer_norm(getattr(self, f"block_{i}")(enc))
        return enc

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        x_enc = inputs["x_enc"]
        if self.task == "classification":
            out = F.gelu(self._backbone(x_enc, generator))
            if self.training:
                out = dropout(out, self.p, generator)
            return self.projection(out.reshape(out.shape[0], -1))
        mask = inputs.get("mask") if self.task == "imputation" else None
        x, means, stdev = (masked_window_norm(x_enc, mask) if mask is not None
                           else window_norm(x_enc))
        out = self.projection(self._backbone(x, generator))
        if self.task in ("forecasting", "reconstruction", "anomaly_detection", "imputation"):
            out = out * stdev[:, 0:1] + means[:, 0:1]
            return out[:, -self.pred_len:] if self.task == "forecasting" else out
        out = out.squeeze(-1) if out.shape[-1] == 1 else out
        if not self.training:
            if self.task == "semantic_segmentation":
                out = torch.softmax(out, dim=-1) if self.num_class > 2 else torch.sigmoid(out)
            elif self.seg_mode == "boundary-prediction":
                out = torch.sigmoid(out)
        return out
