"""Forecasting task (port of ``medtsllm_tpu/tasks/forecasting.py``): the
model sees ``history_len`` steps and predicts the next ``pred_len``; the
window predictions are stitched at each target range's start (the window's
start + ``history_len``), the history span dropped, the step > pred_len
de-duplication applied, and scored by MSE and MAE."""

from __future__ import annotations

import numpy as np

from .base import BaseTask, stitch_channels


class ForecastTask(BaseTask):
    task = "forecasting"

    def predict(self, pipeline):
        dataset = pipeline.dataset
        ctx = self.config.history_len
        n_points = self.eval_n_points(dataset, include_history=True)
        out = self.run_eval(pipeline, extra_keys=("y", "index"))
        pred = out["pred"].reshape(out["pred"].shape[0], self.config.pred_len, -1)
        target = out["y"].reshape(pred.shape)
        idx = out["index"]
        starts = np.asarray(dataset.x_starts(idx)) + ctx
        preds = stitch_channels(dataset, pred, starts, n_points, idx)[ctx:]
        targets = stitch_channels(dataset, target, starts, n_points, idx)[ctx:]
        return self.finalize_series(dataset, preds, targets)

    def score(self, pred, target):
        err = pred - target
        return {"mse": float(np.mean(err ** 2)), "mae": float(np.mean(np.abs(err)))}
