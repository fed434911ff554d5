"""Anomaly detection task (port of ``medtsllm_tpu/tasks/anomaly_detection.py``).

Reconstruction-based: the window reconstructions are stitched, each
point's score is its squared error averaged over the features (optionally
each feature's error over its mean first, and the scores over their moving
average), the threshold is a quantile of the scores (``auto``: one minus
the share of anomalous points in this split and the train split; one minus
a fixed rate; ``optimize``: the quantile that maximises the split's
point-adjusted F1, by Bayesian optimisation, or ``optimize-test`` that on
the test split and ``auto`` elsewhere), and the predictions are
point-adjusted before the metrics (``tasks/metrics.py``; AUROC on the
continuous scores).
"""

from __future__ import annotations

import numpy as np

from ..data import stitch_windows
from . import metrics as M
from .base import BaseTask, stitch_channels
from .bayesopt import BayesianOptimization
from .postproc import adjust_anomalies, running_mean


class AnomalyDetectionTask(BaseTask):
    task = "anomaly_detection"

    def __init__(self, run_id, config, device="cuda"):
        self.task_config = config.tasks.anomaly_detection
        if config.history_len != config.pred_len:
            raise ValueError("Anomaly detection task requires history_len == pred_len")
        if self.task_config.get("score_metric", "mse") != "mse":
            raise ValueError("anomaly detection scores by mse")
        super().__init__(run_id, config, device)

    def evaluate(self, pipeline, split: str | None = None) -> dict:
        results = self.predict(pipeline, split)
        return (self.score_anomalies(results["anomaly_preds"], results["anomaly_labels"],
                                     scores=results["anomaly_scores"])
                | self.score(results["recon_preds"], results["recon_targets"])
                | {"anomaly_quantile": results["anomaly_quantile"],
                   "anomaly_threshold": results["anomaly_threshold"]})

    def predict(self, pipeline, split: str | None = None) -> dict:
        dataset = pipeline.dataset
        n_points = self.eval_n_points(dataset, include_history=False)
        out = self.run_eval(pipeline, extra_keys=("x_enc", "labels", "index"))
        pred = out["pred"].reshape(out["pred"].shape[0], self.config.pred_len, -1)
        target = out["x_enc"].reshape(pred.shape)
        lbl = out["labels"].reshape(out["labels"].shape[0], -1)
        idx = out["index"]
        starts = np.asarray(dataset.x_starts(idx))
        preds = stitch_channels(dataset, pred, starts, n_points, idx)
        targets = stitch_channels(dataset, target, starts, n_points, idx)
        labels = stitch_windows(lbl.astype(np.float32), starts, n_points,
                                fill=-1.0).astype(np.int64)
        preds, targets, labels = self.finalize_series(dataset, preds, targets, labels)
        if (labels < 0).any():
            raise ValueError("unfilled labels after stitching")
        return self.detect(preds, targets, labels, n_points, split)

    def detect(self, preds, targets, labels, n_points: int, split: str | None = None) -> dict:
        """The stitched series of ``split`` -> per-point scores, the
        quantile and its threshold, and the point-adjusted predictions."""
        scores = (preds - targets) ** 2
        if self.task_config.normalize_by_feature:
            scores = scores / scores.mean(axis=0, keepdims=True)
        scores = np.nanmean(scores, axis=1)
        window = self.task_config.get("normalize_moving_window", 0)
        if window and window > 0:
            scores = scores / running_mean(scores, int(window))
        thr_cfg = self.task_config.threshold
        if thr_cfg == "optimize" or (thr_cfg == "optimize-test" and split == "test"):
            quantile = optimize_threshold(scores, labels)
        elif thr_cfg in ("auto", "optimize-test"):
            quantile = 1 - (labels.sum() / (n_points + self.train_dataset.n_points))
        elif isinstance(thr_cfg, (float, int)) and not isinstance(thr_cfg, bool):
            quantile = 1 - float(thr_cfg)
        else:
            raise ValueError(f"Invalid threshold selection: {thr_cfg}")
        threshold = np.quantile(scores, quantile)
        anomalies = adjust_anomalies((scores > threshold).astype(np.int64), labels)
        return {"recon_preds": preds, "recon_targets": targets, "anomaly_labels": labels,
                "anomaly_scores": scores, "anomaly_preds": anomalies,
                "anomaly_quantile": float(quantile), "anomaly_threshold": float(threshold)}

    def score(self, pred, target) -> dict:
        err = pred - target
        return {"recon_mse": float(np.mean(err ** 2)),
                "recon_mae": float(np.mean(np.abs(err)))}

    def score_anomalies(self, pred, target, scores=None) -> dict:
        """AUROC ranks the continuous scores where given (the JAX package's
        deliberate change from the reference's binarised input)."""
        return {
            "accuracy": M.accuracy(target, pred),
            "f1": M.f1(target, pred),
            "auroc": (M.roc_auc(target, scores if scores is not None else pred)
                      if len(np.unique(target)) > 1 else 0.5),
            "precision": M.precision(target, pred),
            "recall": M.recall(target, pred),
            "iou": M.jaccard(target, pred),
        }


def optimize_threshold(scores: np.ndarray, labels: np.ndarray) -> float:
    """The score quantile in [0.5, 1] that maximises the point-adjusted
    F1: 10 random points, then 20 by Bayesian optimisation."""

    def score_func(q):
        anomalies = (scores > np.quantile(scores, q)).astype(np.int64)
        return M.f1(labels, adjust_anomalies(anomalies, labels))

    opt = BayesianOptimization(f=score_func, pbounds={"q": (0.5, 1.0)}, random_state=0,
                               verbose=0)
    opt.maximize(init_points=10, n_iter=20)
    return opt.max["params"]["q"]
