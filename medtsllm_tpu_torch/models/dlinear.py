"""DLinear (port of ``medtsllm_tpu/models/dlinear.py``): the moving-average
decomposition, a linear map over time for the seasonal and the trend part,
and each task's head.

The weights are the flax tree's: ``{seasonal,trend}_w`` [seq, pred] (or
[C, seq, pred] with ``individual``, one map per channel) initialised to
1 / seq_len, ``{seasonal,trend}_b`` zeros, and a Dense ``projection`` for
classification and the segmentations. Where the reference oracle and the
JAX package part (ROADMAP queue 3: ``test_dlinear_heads_oracle``,
``test_dlinear_trainer_trajectory_oracle``), the port matches the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decomp import series_decomp
from .llm.transformer import Linear

SUPPORTED_TASKS = ("forecasting", "anomaly_detection", "reconstruction", "imputation",
                   "classification", "semantic_segmentation", "segmentation")


class DLinear(nn.Module):
    supported_tasks = SUPPORTED_TASKS

    def __init__(self, *, task, seq_len, pred_len, channels, n_classes, individual,
                 moving_avg_kernel, seg_mode=None):
        super().__init__()
        self.task, self.seq_len, self.pred_len = task, seq_len, pred_len
        self.n_classes, self.individual = n_classes, individual
        self.moving_avg_kernel, self.seg_mode = moving_avg_kernel, seg_mode
        lead = (channels,) if individual else ()
        for name in ("seasonal", "trend"):
            setattr(self, f"{name}_w", nn.Parameter(torch.empty(*lead, seq_len, pred_len)))
            setattr(self, f"{name}_b", nn.Parameter(torch.zeros(*lead, pred_len)))
        if task == "classification":
            self.projection = Linear(pred_len * channels, n_classes)
        elif task == "semantic_segmentation":
            self.projection = Linear(pred_len * channels,
                                     pred_len * n_classes if n_classes > 2 else pred_len)
        elif task == "segmentation":
            self.projection = Linear(pred_len * channels, seq_len)
        elif task not in ("forecasting", "anomaly_detection", "reconstruction", "imputation"):
            raise ValueError(f"Invalid task for DLinear: {task}")

    @classmethod
    def from_config(cls, config, dataset):
        task = config.task
        return cls(
            task=task, seq_len=config.history_len,
            pred_len=config.pred_len if task == "forecasting" else config.history_len,
            channels=dataset.n_features,
            n_classes=(dataset.n_classes
                       if task in ("classification", "semantic_segmentation") else 0),
            individual=config.models.dlinear.individual,
            moving_avg_kernel=config.models.dlinear.moving_avg,
            seg_mode=config.tasks.segmentation.mode if task == "segmentation" else None)

    def _branch_linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, seq] -> [B, C, pred]."""
        w, b = getattr(self, f"{name}_w"), getattr(self, f"{name}_b")
        if self.individual:
            return torch.einsum("bcs,csp->bcp", x, w) + b[None]
        return torch.einsum("bcs,sp->bcp", x, w) + b[None, None]

    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        seasonal, trend = series_decomp(x, self.moving_avg_kernel)
        out = (self._branch_linear("seasonal", seasonal.transpose(1, 2))
               + self._branch_linear("trend", trend.transpose(1, 2)))
        return out.transpose(1, 2)  # [B, pred, C]

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        enc = self.encoder(inputs["x_enc"])
        if self.task == "forecasting":
            return enc[:, -self.pred_len:, :]
        if self.task in ("anomaly_detection", "reconstruction", "imputation"):
            return enc
        if self.task == "classification":
            # the reference never applies its activation or dropout here
            return self.projection(enc.reshape(enc.shape[0], -1))
        out = self.projection(F.gelu(enc).reshape(enc.shape[0], -1))
        if self.task == "semantic_segmentation":
            if self.n_classes > 2:
                # always [B, L, C] (the reference leaves training's flat)
                out = out.reshape(out.shape[0], self.pred_len, self.n_classes)
                return out if self.training else torch.softmax(out, dim=-1)
            return out if self.training else torch.sigmoid(out)
        if not self.training and self.seg_mode == "boundary-prediction":
            out = torch.sigmoid(out)
        return out
