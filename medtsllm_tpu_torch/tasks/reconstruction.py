"""Reconstruction task (port of ``medtsllm_tpu/tasks/reconstruction.py``):
the target is the input window; predictions are stitched over the input
range and scored by MSE and MAE, on the val split after each epoch and on
the test split."""

from __future__ import annotations

import numpy as np

from ..data import stitch_windows
from .base import BaseTask


class ReconstructionTask(BaseTask):
    task = "reconstruction"

    def predict(self, pipeline):
        dataset = pipeline.dataset
        n_points = self.eval_n_points(dataset, include_history=False)
        out = self.run_eval(pipeline, extra_keys=("x_enc", "index"))
        pred = out["pred"].reshape(out["pred"].shape[0], self.config.pred_len, -1)
        target = out["x_enc"].reshape(pred.shape)
        starts = np.asarray(dataset.x_starts(out["index"]))
        kw = dict(n_points=n_points, n_channels=dataset.real_features)
        preds = stitch_windows(pred, starts, **kw)
        targets = stitch_windows(target, starts, **kw)
        return self.finalize_series(dataset, preds, targets)

    def score(self, pred, target):
        err = pred - target
        return {"mse": float(np.mean(err ** 2)), "mae": float(np.mean(np.abs(err)))}
