"""Loss functions with batch-validity masking (port of
``medtsllm_tpu/tasks/losses.py``: the regression losses, the binary and
multiclass cross-entropies, imputation's held-out point loss, the soft
Jaccard loss and the Lovasz hinge, and ``build_loss``'s table for the
reconstruction, anomaly-detection, segmentation, semantic-segmentation,
forecasting, classification and imputation tasks).

The batch pipeline pads the final batch to a fixed shape, so every loss is
computed per sample and averaged over the valid rows only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def bce_with_logits(pred, target, valid):
    """optax.sigmoid_binary_cross_entropy, averaged per sample."""
    t = target.to(pred.dtype)
    loss = -t * F.logsigmoid(pred) - (1.0 - t) * F.logsigmoid(-pred)
    return _masked_mean(_per_sample(loss), valid)


def cross_entropy(logits, labels, valid):
    """logits [B, L, n_classes], labels [B, L] int:
    optax.softmax_cross_entropy_with_integer_labels, averaged per sample."""
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return _masked_mean(_per_sample(torch.logsumexp(logits, dim=-1) - picked), valid)


def masked_point_loss(pred, target, mask, valid, kind: str = "mse"):
    """Imputation's loss: the mean error over the held-out points only.
    pred, target, mask [B, L, C] (mask 1 = observed, 0 = held out)."""
    hold = 1.0 - mask.to(pred.dtype)
    d = pred - target
    err = (d * d if kind == "mse" else d.abs()) * hold
    B = pred.shape[0]
    per_sample = (err.reshape(B, -1).sum(dim=1)
                  / hold.reshape(B, -1).sum(dim=1).clamp(min=1.0))
    return _masked_mean(per_sample, valid)


def jaccard_loss(pred, target, valid, binary: bool = True, eps: float = 1e-7):
    """Soft IoU loss: sigmoid scores against 0/1 targets, or (``binary``
    False) softmax scores [B, L, C] against one-hot integer targets [B, L],
    averaged over the classes."""
    if binary:
        p = torch.sigmoid(pred).reshape(pred.shape[0], -1)
        t = target.to(p.dtype).reshape(pred.shape[0], -1)
        inter = (p * t).sum(dim=1)
        union = (p + t).sum(dim=1) - inter
        loss = 1.0 - (inter + eps) / (union + eps)
    else:
        p = torch.softmax(pred, dim=-1)
        t = F.one_hot(target.long(), pred.shape[-1]).to(p.dtype)
        inter = (p * t).sum(dim=1)
        union = (p + t).sum(dim=1) - inter
        loss = (1.0 - (inter + eps) / (union + eps)).mean(dim=-1)
    return _masked_mean(loss, valid)


def lovasz_hinge(pred, target, valid):
    """Binary Lovasz hinge, per sample: hinge errors sorted in descending
    order (stable), weighted by the Lovasz extension's Jaccard increments."""
    B = pred.shape[0]
    logits = pred.reshape(B, -1)
    labels = target.to(logits.dtype).reshape(B, -1)
    errors = 1.0 - logits * (2.0 * labels - 1.0)
    order = torch.argsort(-errors, dim=1, stable=True)
    errors_sorted = errors.gather(1, order)
    lb = labels.gather(1, order)
    gts = lb.sum(dim=1, keepdim=True)
    intersection = gts - lb.cumsum(dim=1)
    union = gts + (1.0 - lb).cumsum(dim=1)
    jac = 1.0 - intersection / union.clamp(min=1e-7)
    jac = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=1)
    return _masked_mean((F.relu(errors_sorted) * jac).sum(dim=1), valid)


_REGRESSION = {"mse": mse, "mae": mae, "smooth_l1": smooth_l1, "smooth_mae": smooth_l1}


def build_loss(name: str, task: str, n_classes: int = 0):
    """(pred, arrays, valid) -> scalar loss for the config's loss name and
    task, in the order of ``build_loss``'s table in the JAX package:
    classification takes cross-entropy on its window labels and nothing
    else (a regression arm would broadcast [B, C] logits against [B]
    labels); imputation mse or mae on the held-out points of the unmasked
    window ``y`` (no gradient); forecasting regresses ``y``, reconstruction
    and anomaly detection the input window (``x_enc``), both without
    gradient; segmentation takes bce or mse / mae on its labels; semantic
    segmentation bce (two classes) or cross-entropy; iou / jaccard and,
    with two classes, lovasz."""
    is_binary = n_classes == 2
    key = {"forecasting": "y", "reconstruction": "x_enc",
           "anomaly_detection": "x_enc"}.get(task, "labels")

    if task == "classification":
        if name not in ("ce", "cross_entropy", "auto"):
            raise ValueError("classification requires a cross-entropy loss "
                             f"(ce/cross_entropy/auto), got {name!r}")
        return lambda p, b, v: cross_entropy(p, b["labels"], v)
    if task == "imputation":
        if name not in ("mse", "mae"):
            raise ValueError(f"imputation supports mse/mae losses, got {name!r}")
        return lambda p, b, v: masked_point_loss(p, b["y"].detach(), b["mask"], v, kind=name)

    def regression(fn):
        return lambda p, b, v: fn(p, b[key].detach(), v)

    if name in ("mse", "mae") and task != "segmentation":
        return regression(_REGRESSION[name])
    if name in ("smooth_l1", "smooth_mae"):
        return regression(smooth_l1)
    if task == "segmentation" and name == "bce":
        return lambda p, b, v: bce_with_logits(p, b["labels"], v)
    if task == "segmentation" and name in ("mse", "mae"):
        fn = _REGRESSION[name]
        return lambda p, b, v: fn(p, b["labels"].to(p.dtype), v)
    if task == "semantic_segmentation" and is_binary and name in (
            "bce", "ce", "cross_entropy", "auto"):
        return lambda p, b, v: bce_with_logits(p, b["labels"], v)
    if task == "semantic_segmentation" and name in ("ce", "cross_entropy", "auto"):
        return lambda p, b, v: cross_entropy(p, b["labels"], v)
    if name in ("iou", "jaccard"):
        return lambda p, b, v: jaccard_loss(p, b["labels"], v, binary=is_binary)
    if name in ("lovasz", "lovasz-hinge") and is_binary:
        return lambda p, b, v: lovasz_hinge(p, b["labels"], v)
    raise ValueError(f"Invalid loss function selection: {name} for task {task}")
