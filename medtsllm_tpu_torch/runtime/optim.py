"""The optimizer of the train step (port of ``medtsllm_tpu/runtime/optim.py``:
``Optimizer`` with adam, adamw and sgd, the per-epoch learning-rate schedules
and the global-norm gradient clip).

Only the trainable parameters reach it (the frozen backbone's have
``requires_grad = False``). The update rules are optax's: ``adam`` (b1 0.9,
b2 0.999, eps 1e-8), ``adamw`` (weight decay 0.01, decoupled: ``p -= lr *
(adam + 0.01 p)``) and ``sgd`` (momentum 0.9, nesterov), which
``torch.optim.Adam`` / ``AdamW`` / ``SGD`` compute with these arguments
(tests/test_torch_train.py holds them to optax). The moments live at the
parameters' dtype, as optax keeps them.
"""

from __future__ import annotations

import math

import torch

_UNPORTED = '(ROADMAP queue 1, "Training on the served backbones")'


class Optimizer:
    def __init__(self, config, params):
        t = config.training
        self.name = t.optimizer
        self.base_lr = float(t.learning_rate)
        if self.name in ("ranger", "ranger21", "ranger_classic"):
            raise NotImplementedError(f"optimizer {self.name!r} is not ported {_UNPORTED}")
        if int(t.get("grad_accum_steps", 1) or 1) > 1:
            raise NotImplementedError(f"training.grad_accum_steps > 1 is not ported {_UNPORTED}")
        if config.get("finetuning", {}).get("enabled", False):
            raise NotImplementedError("finetuning from a pretrained run (the 'loaded' "
                                      f"parameter group) is not ported {_UNPORTED}")
        scheduler = t.get("lr_scheduler")
        if scheduler not in (None, "none", "constant", "cosine", "linear"):
            raise ValueError(f"Invalid scheduler selection: {scheduler}")
        self.schedule = scheduler if scheduler in ("cosine", "linear") else "constant"
        self.total_epochs = int(t.get("epochs", 1) or 1)
        self.lr_min_factor = float(t.get("lr_min_factor", 0.0) or 0.0)
        self.lr_warmup_epochs = int(t.get("lr_warmup_epochs", 0) or 0)
        self.clip_norm = float(t.get("grad_clip_norm", 0.0) or 0.0)

        self.params = [p for p in params if p.requires_grad]
        match self.name:
            case "adam":
                self._opt = torch.optim.Adam(self.params, lr=self.base_lr,
                                             betas=(0.9, 0.999), eps=1e-8)
            case "adamw":
                self._opt = torch.optim.AdamW(self.params, lr=self.base_lr,
                                              betas=(0.9, 0.999), eps=1e-8,
                                              weight_decay=0.01)
            case "sgd":
                self._opt = torch.optim.SGD(self.params, lr=self.base_lr, momentum=0.9,
                                            nesterov=True)
            case _:
                raise ValueError(f"Invalid optimizer selection: {self.name}")
        self.last_lrs = [self.base_lr]

    def schedule_factor(self, epoch: int) -> float:
        """Per-epoch LR factor (0-based epoch): linear warmup over
        ``lr_warmup_epochs``, then cosine or linear decay to
        ``lr_min_factor`` at the final epoch."""
        w = self.lr_warmup_epochs
        if w > 0 and epoch < w:
            return (epoch + 1) / w
        if self.schedule == "constant":
            return 1.0
        span = max(self.total_epochs - 1 - w, 1)
        t = min(max(epoch - w, 0), span) / span
        mf = self.lr_min_factor
        if self.schedule == "cosine":
            return mf + (1.0 - mf) * 0.5 * (1.0 + math.cos(math.pi * t))
        return 1.0 - (1.0 - mf) * t

    def set_epoch(self, epoch: int) -> None:
        lr = self.base_lr * self.schedule_factor(epoch)
        for group in self._opt.param_groups:
            group["lr"] = lr
        self.last_lrs = [lr]

    def get_last_lr(self) -> list[float]:
        return list(self.last_lrs)

    def zero_grad(self) -> None:
        self._opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip (one global norm over every gradient, in f32; scale
        min(1, max_norm / max(norm, 1e-16)) as ``clip_global_norm_float``),
        then update."""
        if self.clip_norm > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            if grads:
                norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
                scale = (self.clip_norm / norm.clamp(min=1e-16)).clamp(max=1.0)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
        self._opt.step()
