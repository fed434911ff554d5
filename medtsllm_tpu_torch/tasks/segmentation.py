"""Boundary segmentation task (port of ``medtsllm_tpu/tasks/segmentation.py``).

Two modes: boundary-prediction (a sigmoid score per step, trained with bce
on the boundary indicators) and steps-to-boundary (the normalised distance
to the next boundary, regressed). Boundaries are the peaks of the stitched
scores (``scipy.signal.find_peaks``) at an ``auto`` (the 10th percentile of
the true segment lengths), ``optimize`` (the distance that maximises the
split's segment mIoU, by Bayesian optimisation) or fixed minimum distance;
metrics: point MAE / RMSE / acc@d and segment mIoU / acc@IoU.
"""

from __future__ import annotations

import numpy as np
import scipy.signal

from ..data import stitch_windows
from .base import BaseTask
from .bayesopt import BayesianOptimization
from .postproc import all_pairs_iou, points_to_segments


class SegmentationTask(BaseTask):
    task = "segmentation"

    def __init__(self, run_id, config, newrun=True, device="cuda"):
        self.segmentation_mode = config.tasks.segmentation.mode
        super().__init__(run_id, config, newrun, device)

    def evaluate(self, pipeline, split: str | None = None) -> dict:
        return self.score(self.predict(pipeline))

    def predict(self, pipeline) -> dict:
        dataset = pipeline.dataset
        n_points = self.eval_n_points(dataset, include_history=False)
        out = self.run_eval(pipeline, extra_keys=("labels", "index"))
        pred = out["pred"].reshape(out["pred"].shape[0], -1)
        lbl = out["labels"].reshape(pred.shape)
        starts = np.asarray(dataset.x_starts(out["index"]))
        preds = stitch_windows(pred, starts, n_points)
        targets = stitch_windows(lbl.astype(np.float32), starts, n_points, fill=-1.0)
        preds, targets = self.finalize_series(dataset, preds, targets)
        if (targets < 0).any():
            raise ValueError("unfilled labels after stitching")
        if self.segmentation_mode == "boundary-prediction":
            return self.process_preds_boundary_prediction(preds, targets.astype(np.int64))
        if self.segmentation_mode == "steps-to-boundary":
            return self.process_preds_steps_to_boundary(preds, targets)
        raise ValueError(f"Segmentation mode {self.segmentation_mode} not supported")

    def process_preds_boundary_prediction(self, preds, targets) -> dict:
        """Peaks at least the distance threshold apart."""
        pred_scores = preds.copy()
        thr_cfg = self.config.tasks.segmentation.distance_thresh
        if thr_cfg == "auto":
            seg_lens = np.diff(np.flatnonzero(targets))
            distance_thresh = (1.0 if len(seg_lens) == 0  # < 2 true boundaries
                               else float(np.quantile(seg_lens.astype(np.float64), 0.1)))
        elif thr_cfg == "optimize":
            est = targets.shape[0] / max(targets.sum(), 1)
            distance_thresh = optimize_threshold(pred_scores, targets, est)
        else:
            distance_thresh = float(thr_cfg)
        distance_thresh = max(distance_thresh, 1.0)
        pred_points = scipy.signal.find_peaks(pred_scores, distance=distance_thresh)[0]
        return self._package(pred_scores, preds, targets, pred_points)

    def process_preds_steps_to_boundary(self, preds, targets) -> dict:
        """Peaks and troughs of the sawtooth regression, each point of the
        more numerous kind snapped to the nearest of the other kind when it
        lies within half the estimated segment length."""
        pred_scores = preds.copy()
        targets = (targets == 0).astype(np.int64)
        threshold_est = targets.shape[0] / max(targets.sum(), 1)
        pts_max = scipy.signal.find_peaks(pred_scores, prominence=0.5)[0]
        pts_min = scipy.signal.find_peaks(-pred_scores, prominence=0.5)[0]
        pts_a, pts_b = ((pts_max, pts_min) if len(pts_max) >= len(pts_min)
                        else (pts_min, pts_max))
        if len(pts_b) > 0 and len(pts_a) > 0:
            dists = np.abs(pts_b[None, :] - pts_a[:, None])
            closest = dists.argmin(axis=1)
            snap = dists[np.arange(len(pts_a)), closest] <= threshold_est / 2
            pred_points = np.where(snap, pts_b[closest], pts_a)
        else:
            pred_points = pts_a
        return self._package(pred_scores, preds, targets, pred_points)

    def _package(self, pred_scores, preds, targets, pred_points) -> dict:
        pred_points = np.asarray(pred_points, dtype=np.int64)
        pred_labels = np.zeros_like(targets)
        pred_labels[pred_points] = 1
        label_points = np.flatnonzero(targets)
        n = len(pred_scores)
        return {"preds_raw": preds, "pred_points": pred_points, "pred_labels": pred_labels,
                "pred_segments": points_to_segments(pred_points, n), "labels": targets,
                "label_points": label_points,
                "label_segments": points_to_segments(label_points, n)}

    def score(self, results: dict) -> dict:
        pred_points, target_points = results["pred_points"], results["label_points"]
        if len(pred_points) == 0 or len(target_points) == 0:
            # the full key set with worst-case values, so eval_metric and the
            # logs see one schema every epoch
            worst = {"point_mae": float("inf"), "point_rmse": float("inf"),
                     "segment_miou": 0.0, "pred_label_ratio": 0.0}
            for thresh in (50, 100, 200):
                worst[f"point_acc@{thresh}"] = 0.0
            for thresh in (0.5, 0.75, 0.9):
                worst[f"segment_acc@{int(thresh * 100)}iou"] = 0.0
            return worst
        point_dists = np.abs(pred_points.reshape(-1, 1) - target_points)
        segment_dists = all_pairs_iou(results["pred_segments"], results["label_segments"])
        metrics = {
            "point_mae": float(point_dists.min(axis=0).mean()),
            "point_rmse": float(np.sqrt((point_dists.astype(np.float64) ** 2)
                                        .min(axis=0).mean())),
            "segment_miou": float(segment_dists.max(axis=0).mean()),
            "pred_label_ratio": float(results["pred_labels"].sum()
                                      / max(results["labels"].sum(), 1)),
        }
        for thresh in (50, 100, 200):
            metrics[f"point_acc@{thresh}"] = float((point_dists < thresh).any(axis=0).mean())
        for thresh in (0.5, 0.75, 0.9):
            metrics[f"segment_acc@{int(thresh * 100)}iou"] = float(
                (segment_dists > thresh).any(axis=0).mean())
        return metrics


def optimize_threshold(pred_scores: np.ndarray, targets: np.ndarray, est: float) -> float:
    """The find_peaks distance in [0.5 est, 1.25 est] that maximises the
    segment mIoU: 5 random points, then 10 by Bayesian optimisation."""
    target_segments = points_to_segments(np.flatnonzero(targets), len(pred_scores))

    def score_fn(thresh):
        pred_points = scipy.signal.find_peaks(pred_scores, distance=max(thresh, 1.0))[0]
        pred_segments = points_to_segments(pred_points, len(pred_scores))
        return float(all_pairs_iou(pred_segments, target_segments).max(axis=0).mean())

    opt = BayesianOptimization(f=score_fn, pbounds={"thresh": (0.5 * est, 1.25 * est)},
                               random_state=0, verbose=0, allow_duplicate_points=True)
    opt.maximize(init_points=5, n_iter=10)
    return opt.max["params"]["thresh"]
