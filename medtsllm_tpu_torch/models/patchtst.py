"""PatchTST (port of ``medtsllm_tpu/models/patchtst.py``): channel-
independent patches (the channels folded into the batch) through a
vanilla transformer encoder, then each task's head.

The trunk: the non-stationary window norm (mean detached, the standard
deviation not; under imputation ``masked_window_norm``, both detached,
over the observed points) -> patches (``patch_unfold``) -> a bias-free
Dense value embedding plus sincos positions -> ``e_layers`` post-norm
encoder layers (``FullAttention``, exact GELU) and a LayerNorm ->
[B, C, d_model, P]. The state dict has the flax tree's keys: the layers'
``AttentionLayer_{i}`` and ``encoder_layer_{i}`` lie at the top, as flax
scopes them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import AttentionLayer, FullAttention
from ..ops.embed import dropout, patch_unfold, positions
from ..ops.revin import masked_window_norm
from ..ops.transformer import Encoder, EncoderLayer
from .dlinear import SUPPORTED_TASKS
from .llm.transformer import Linear


def window_norm(x_enc: torch.Tensor):
    """The non-stationary window norm: (x normalized, means, stdev), the
    means detached and the standard deviation not."""
    means = x_enc.mean(dim=1, keepdim=True).detach()
    x = x_enc - means
    stdev = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + 1e-5)
    return x / stdev, means, stdev


class LinearPatchEmbedding(nn.Module):
    """[B, C, L] -> ([B * C, P, d_model], C): the patches through a bias-free
    Dense (``value_embedding``) plus sincos positions; dropout ``p``."""

    def __init__(self, d_model: int, patch_len: int, stride: int, p: float = 0.1):
        super().__init__()
        self.patch_len, self.stride, self.p = patch_len, stride, p
        self.value_embedding = Linear(patch_len, d_model, bias=False)

    def forward(self, x, generator=None):
        B, C, _ = x.shape
        patches = patch_unfold(x, self.patch_len, self.stride)
        P = patches.shape[2]
        out = self.value_embedding(patches.reshape(B * C, P, self.patch_len))
        out = out + positions(P, out.shape[-1], x.device)
        return (dropout(out, self.p, generator) if self.training else out), C


class PatchTST(nn.Module):
    supported_tasks = SUPPORTED_TASKS

    def __init__(self, *, task, seq_len, pred_len, enc_in, num_class, d_model, d_ff,
                 n_heads, e_layers, patch_len, stride, dropout=0.0, seg_mode=None):
        super().__init__()
        self.task, self.seq_len, self.pred_len = task, seq_len, pred_len
        self.num_class, self.p, self.seg_mode = num_class, dropout, seg_mode
        self.patch_len, self.stride = patch_len, stride
        self.patch_embedding = LinearPatchEmbedding(d_model, patch_len, stride, dropout)
        layers = []
        for i in range(e_layers):
            attn = AttentionLayer(FullAttention(mask_flag=False, p=dropout,
                                                output_attention=True), d_model, n_heads)
            setattr(self, f"AttentionLayer_{i}", attn)
            layer = EncoderLayer(attn, d_model, d_ff, p=dropout, activation_name="gelu")
            setattr(self, f"encoder_layer_{i}", layer)
            layers.append(layer)
        self.encoder = Encoder(layers, d_model)
        flat = d_model * self.n_patches
        if task == "forecasting":
            self.head = Linear(flat, pred_len)
        elif task in ("reconstruction", "anomaly_detection", "imputation"):
            self.head = Linear(flat, seq_len)
        elif task == "classification":
            self.projection = Linear(enc_in * flat, num_class)
        elif task == "semantic_segmentation":
            self.projection = Linear(enc_in * flat, seq_len * (num_class if num_class > 2
                                                                else 1))
        elif task == "segmentation":
            self.projection = Linear(enc_in * flat, seq_len)
        else:
            raise ValueError(f"Invalid task for PatchTST: {task}")

    @classmethod
    def from_config(cls, config, dataset):
        mc = config.models.patchtst
        if mc.covariate_mode != "independent":
            raise ValueError("Only independent covariate mode is supported for PatchTST")
        task = config.task
        if task != "forecasting" and config.pred_len != config.history_len:
            raise ValueError(f"{task} requires pred_len == history_len")
        return cls(
            task=task, seq_len=config.history_len,
            pred_len=config.pred_len if task == "forecasting" else 0,
            enc_in=dataset.n_features,
            num_class=(dataset.n_classes
                       if task in ("classification", "semantic_segmentation") else 0),
            d_model=mc.d_model, d_ff=mc.d_ff, n_heads=mc.n_heads, e_layers=mc.e_layers,
            patch_len=mc.patching.patch_len, stride=mc.patching.stride,
            dropout=config.training.dropout,
            seg_mode=config.tasks.segmentation.mode if task == "segmentation" else None)

    @property
    def n_patches(self) -> int:
        return int((self.seq_len - self.patch_len) / self.stride + 2)

    def _drop(self, x, generator):
        return dropout(x, self.p, generator) if self.training else x

    def _encode(self, x, generator, mask=None):
        """-> ([B, C, d_model, P], means, stdev)."""
        x, means, stdev = (masked_window_norm(x, mask) if mask is not None
                           else window_norm(x))
        enc, n_vars = self.patch_embedding(x.transpose(1, 2), generator)
        enc, _ = self.encoder(enc, generator=generator)
        enc = enc.reshape(-1, n_vars, enc.shape[-2], enc.shape[-1])
        return enc.permute(0, 1, 3, 2), means, stdev

    def _regression_head(self, enc, generator):
        """The per-variable FlattenHead: [B, C, d, P] -> [B, target, C]."""
        out = self._drop(self.head(enc.reshape(*enc.shape[:2], -1)), generator)
        return out.transpose(1, 2)

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        mask = inputs.get("mask") if self.task == "imputation" else None
        enc, means, stdev = self._encode(inputs["x_enc"], generator, mask)
        if self.task in ("forecasting", "reconstruction", "anomaly_detection", "imputation"):
            out = self._regression_head(enc, generator) * stdev[:, 0:1] + means[:, 0:1]
            return out[:, -self.pred_len:] if self.task == "forecasting" else out
        flat = enc.reshape(enc.shape[0], -1)
        if self.task == "classification":
            return self.projection(self._drop(flat, generator))
        out = self.projection(flat)
        if self.task == "semantic_segmentation":
            if self.num_class > 2:
                # seq_len, not the reference's zeroed pred_len, which crashes
                out = out.reshape(out.shape[0], self.seq_len, self.num_class)
                return out if self.training else torch.softmax(out, dim=-1)
            return out if self.training else torch.sigmoid(out)
        if not self.training and self.seg_mode == "boundary-prediction":
            out = torch.sigmoid(out)
        return out
