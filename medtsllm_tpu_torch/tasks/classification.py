"""Per-window classification task (port of
``medtsllm_tpu/tasks/classification.py``): the model emits one row of
``n_classes`` logits a window, trained by cross-entropy; eval softmaxes
them on the host in float64 and scores the argmax against the window
labels (no stitching: a window is one sample): accuracy, F1, precision and
recall, binary at two classes, else macro, and AUROC at two classes (NaN
when the labels hold one class). Its figure is the confusion matrix."""

from __future__ import annotations

import numpy as np

from . import metrics as M
from .base import BaseTask


def softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class ClassificationTask(BaseTask):
    task = "classification"
    figure = "confusion"

    def predict(self, pipeline):
        out = self.run_eval(pipeline, extra_keys=("labels",))
        logits = out["pred"].reshape(out["pred"].shape[0], -1)  # [n, C]
        return softmax(logits.astype(np.float64)), out["labels"].astype(np.int64)

    def score(self, probs, target) -> dict:
        n_classes = probs.shape[1]
        avg = "binary" if n_classes == 2 else "macro"
        pred = probs.argmax(axis=1).astype(np.int64)
        scores = {"accuracy": M.accuracy(target, pred),
                  "f1": M.f1(target, pred, avg),
                  "precision": M.precision(target, pred, avg),
                  "recall": M.recall(target, pred, avg)}
        if n_classes == 2:
            scores["auroc"] = (M.roc_auc(target, probs[:, 1])
                               if len(np.unique(target)) > 1 else float("nan"))
        return scores

    def plot_predictions(self, probs, target):
        """The confusion matrix (rows true, columns predicted)."""
        import matplotlib.pyplot as plt
        n_classes = probs.shape[1]
        cm = np.zeros((n_classes, n_classes), dtype=np.int64)
        np.add.at(cm, (target, probs.argmax(axis=1)), 1)
        fig, ax = plt.subplots(figsize=(4.5, 4))
        im = ax.imshow(cm, cmap="Blues")
        for i in range(n_classes):
            for j in range(n_classes):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=8)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        return fig
