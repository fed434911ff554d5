"""Reconstruction task (port of ``medtsllm_tpu/tasks/reconstruction.py``):
the target is the input window; predictions are stitched over the input
range and scored by MSE and MAE, on the val split after each epoch and on
the test split."""

from __future__ import annotations

import numpy as np

from .base import BaseTask, stitch_channels


class ReconstructionTask(BaseTask):
    task = "reconstruction"

    def predict(self, pipeline):
        dataset = pipeline.dataset
        n_points = self.eval_n_points(dataset, include_history=False)
        out = self.run_eval(pipeline, extra_keys=("x_enc", "index"))
        pred = out["pred"].reshape(out["pred"].shape[0], self.config.pred_len, -1)
        target = out["x_enc"].reshape(pred.shape)
        idx = out["index"]
        starts = np.asarray(dataset.x_starts(idx))
        preds = stitch_channels(dataset, pred, starts, n_points, idx)
        targets = stitch_channels(dataset, target, starts, n_points, idx)
        return self.finalize_series(dataset, preds, targets)

    def score(self, pred, target):
        err = pred - target
        return {"mse": float(np.mean(err ** 2)), "mae": float(np.mean(np.abs(err)))}
