"""Imputation task (port of ``medtsllm_tpu/tasks/imputation.py``): each
window is masked element-wise at ``tasks.imputation.mask_rate`` (mask 1 =
observed, 0 = held out), from a generator seeded by the run's seed, a salt
and the window's global index, so eval can draw the same masks again on
the host. The model takes the zero-filled window as ``x_enc`` and the
``mask`` (its RevIN statistics cover the observed points); the unmasked
window rides in ``y`` for the loss, which counts the held-out points only.

The prompt's input statistics come from the unmasked window (the builder
runs before the mask, as in JAX). The train step salts the masks by epoch
and, as JAX's, builds its inputs with the base ``model_inputs``: the
prompt head is embedded in the train step, not served from the cache.
Scores: ``masked_mse`` and ``masked_mae`` over the held-out points and
``full_mse`` over every point. Its figure is a window's first feature,
imputed against the target, the held-out points marked."""

from __future__ import annotations

import numpy as np

from .base import BaseTask


class ImputationTask(BaseTask):
    task = "imputation"
    figure = "imputation"

    def mask_for(self, indices, shape, salt: int = 0) -> np.ndarray:
        """[len(indices), *shape] float32 masks, one generator per window."""
        rate = float(self.config.get("tasks", {}).get("imputation", {})
                     .get("mask_rate", 0.25))
        seed = int(self.config.setup.seed)
        masks = np.empty((len(indices),) + tuple(shape), np.float32)
        for i, idx in enumerate(np.asarray(indices)):
            rng = np.random.default_rng((seed + 1) * 1_000_003 + salt * 7_777_777 + int(idx))
            masks[i] = rng.random(shape) >= rate
        return masks

    def with_mask(self, arrays: dict, salt: int = 0) -> dict:
        """Host inputs with ``x_enc`` masked (zero-filled), the unmasked
        window in ``y`` and the ``mask``."""
        x = np.asarray(arrays["x_enc"])
        mask = self.mask_for(arrays["index"], x.shape[1:], salt=salt)
        return dict(arrays, y=x, x_enc=x * mask, mask=mask)

    def model_inputs(self, batch: dict) -> dict:
        return self.with_mask(super().model_inputs(batch))

    def train_model_inputs(self, batch: dict) -> dict:
        return self._to_device(self.with_mask(BaseTask.model_inputs(self, batch),
                                              salt=self.epoch))

    def predict(self, pipeline):
        """(window predictions, the unmasked windows, their masks)."""
        out = self.run_eval(pipeline, extra_keys=("x_enc", "index"))
        target = out["x_enc"]  # the raw batch's window
        return out["pred"], target, self.mask_for(out["index"], target.shape[1:])

    def score(self, pred, target, mask) -> dict:
        hold = (1.0 - mask).astype(bool)
        diff = pred - target
        n_hold = max(int(hold.sum()), 1)
        return {"masked_mse": float((diff[hold] ** 2).sum() / n_hold),
                "masked_mae": float(np.abs(diff[hold]).sum() / n_hold),
                "full_mse": float((diff ** 2).mean())}

    def plot_predictions(self, pred, target, mask, window: int = 0):
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(12, 4))
        t, p = target[window, :, 0], pred[window, :, 0]
        m = mask[window, :, 0].astype(bool)
        xs = np.arange(len(t))
        ax.plot(xs, t, label="target", lw=0.8)
        ax.plot(xs, p, label="imputed", lw=0.8)
        ax.scatter(xs[~m], t[~m], s=10, c="red", label="held out")
        ax.legend(loc="upper right")
        fig.tight_layout()
        return fig
