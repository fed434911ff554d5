"""Semantic segmentation task (port of
``medtsllm_tpu/tasks/semantic_segmentation.py``): a class per time step.
The per-class score series are stitched (two classes: the class-1 sigmoid
and its complement; more: the softmax per class) and scored on their
argmax: accuracy, F1, precision, recall and IoU, binary or macro. Its
figure overlays the first 1000 points' labels and predictions."""

from __future__ import annotations

import numpy as np

from ..data import stitch_windows
from . import metrics as M
from .base import BaseTask


class SemanticSegmentationTask(BaseTask):
    task = "semantic_segmentation"
    figure = "predictions"

    def predict(self, pipeline):
        dataset = pipeline.dataset
        n_points = self.eval_n_points(dataset, include_history=False)
        n_classes = dataset.n_classes
        out = self.run_eval(pipeline, extra_keys=("labels", "index"))
        pred = out["pred"]  # [n, L] sigmoid (binary) or [n, L, C] softmax
        lbl = out["labels"].reshape(out["labels"].shape[0], -1)
        starts = np.asarray(dataset.x_starts(out["index"]))
        if n_classes == 2:
            p1 = stitch_windows(pred.reshape(pred.shape[0], -1), starts, n_points)
            preds = np.stack([1 - p1, p1], axis=1)
        else:
            preds = stitch_windows(pred.reshape(pred.shape[0], self.config.pred_len,
                                                n_classes),
                                   starts, n_points, n_channels=n_classes)
        labels = stitch_windows(lbl.astype(np.float32), starts, n_points,
                                fill=-1.0).astype(np.int64)
        preds, labels = self.finalize_series(dataset, preds, labels)
        if (labels < 0).any():
            raise ValueError("unfilled labels after stitching")
        return preds, labels

    def score(self, pred_scores, target) -> dict:
        avg = "binary" if pred_scores.shape[1] == 2 else "macro"
        pred = pred_scores.argmax(axis=1).astype(np.int64)
        return {"accuracy": M.accuracy(target, pred),
                "f1": M.f1(target, pred, avg),
                "precision": M.precision(target, pred, avg),
                "recall": M.recall(target, pred, avg),
                "iou": M.jaccard(target, pred, avg)}

    def plot_predictions(self, pred_scores, targets, xrange=(0, 1000)):
        import matplotlib.pyplot as plt
        sl = slice(*xrange)
        fig, ax = plt.subplots(figsize=(12, 4))
        xs = np.arange(len(targets[sl]))
        ax.plot(xs, targets[sl], label="target", lw=0.8)
        pred = (pred_scores[sl, 1] if pred_scores.shape[1] == 2
                else pred_scores.argmax(axis=1)[sl])
        ax.plot(xs, pred, label="pred", lw=0.8)
        ax.legend(loc="upper right")
        fig.tight_layout()
        return fig
