"""Loss functions with batch-validity masking (port of
``medtsllm_tpu/tasks/losses.py``, the regression losses).

The batch pipeline pads the final batch to a fixed shape, so every loss is
computed per sample and averaged over the valid rows only.
"""

from __future__ import annotations

import torch


def _masked_mean(per_sample: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """per_sample [B], valid [B] bool -> the mean over the valid rows."""
    v = valid.to(per_sample.dtype)
    return (per_sample * v).sum() / v.sum().clamp(min=1.0)


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def mse(pred, target, valid):
    return _masked_mean(_per_sample((pred - target) ** 2), valid)


def mae(pred, target, valid):
    return _masked_mean(_per_sample((pred - target).abs()), valid)


def smooth_l1(pred, target, valid, beta: float = 1.0):
    d = (pred - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _masked_mean(_per_sample(loss), valid)


_REGRESSION = {"mse": mse, "mae": mae, "smooth_l1": smooth_l1, "smooth_mae": smooth_l1}


def build_loss(name: str, task: str):
    """(pred, arrays, valid) -> scalar loss for the config's loss name: the
    reconstruction task's regression losses against the input window
    (``x_enc``, no gradient), as ``build_loss`` of the JAX package."""
    if task != "reconstruction" or name not in _REGRESSION:
        raise NotImplementedError(f"loss {name!r} for task {task!r}: the port trains "
                                  "reconstruction with mse / mae / smooth_l1 "
                                  "(ROADMAP queue 1 item 7)")
    fn = _REGRESSION[name]

    def loss(pred, arrays, valid):
        return fn(pred, arrays["x_enc"].detach(), valid)
    return loss
