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

    def val(self):
        preds, targets = self.predict(self.val_pipeline)
        return {f"val/{k}": v for k, v in self.score(preds, targets).items()}

    def test(self):
        preds, targets = self.predict(self.test_pipeline)
        return {f"test/{k}": v for k, v in self.score(preds, targets).items()}

    def predict(self, pipeline):
        dataset = pipeline.dataset
        n_points = self.eval_n_points(dataset)
        n_features = dataset.n_features
        out = self.run_eval(pipeline, extra_keys=("x_enc", "index"))
        pred = out["pred"].reshape(out["pred"].shape[0], self.config.pred_len, -1)
        target = out["x_enc"].reshape(pred.shape)
        starts = np.asarray(dataset.x_starts(out["index"]))
        preds = stitch_windows(pred, starts, n_points, n_features)
        targets = stitch_windows(target, starts, n_points, n_features)
        return self.finalize_series(preds, targets)

    def score(self, pred, target):
        err = pred - target
        return {"mse": float(np.mean(err ** 2)), "mae": float(np.mean(np.abs(err)))}
