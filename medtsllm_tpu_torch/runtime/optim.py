"""The optimizer of the train step (port of ``medtsllm_tpu/runtime/optim.py``:
``Optimizer`` with adam, adamw and sgd, the per-epoch learning-rate schedules,
the global-norm gradient clip and finetuning's ``loaded`` group).

Only the trainable parameters reach it (the frozen backbone's have
``requires_grad = False``). The update rules are optax's: ``adam`` (b1 0.9,
b2 0.999, eps 1e-8), ``adamw`` (weight decay 0.01, decoupled: ``p -= lr *
(adam + 0.01 p)``) and ``sgd`` (momentum 0.9, nesterov), which
``torch.optim.Adam`` / ``AdamW`` with these arguments and ``DeviceLRSGD``
compute (tests/test_torch_train.py holds them to optax). The moments live at the
parameters' dtype, as optax keeps them.

The epoch's learning rate lives in a tensor on the parameters' device
(``lr``), which ``set_epoch`` writes in place. The update reads it there,
so a captured train step (``runtime/graph.py``) follows the schedule. SGD
is ``DeviceLRSGD`` on every device (torch's SGD turns a tensor LR into a
host number). Adam and AdamW are ``capturable`` on a CUDA device (the step
count and the bias correction on the device too); on the CPU, where torch
makes no optimizer capturable, their groups take the LR as a Python
number. The clip makes no host read.

Finetuning from a pretraining run (``finetuning.enabled``): the parameters
restored from the pretraining checkpoint (``loaded``) form a second group
with an LR tensor of its own (``loaded_lr``), the shared schedule's factor
times the group's own: 0 for ``frozen_epochs`` and then 1, or
``linspace(warmup_factor, 1, warmup_epochs)`` then 1 (JAX's
``loaded_factor``). A frozen epoch's LR is 0, not a skipped update: Adam's
moments advance and the parameters stay put, as optax's do at LR 0; and a
step captured in a frozen epoch reads the group's LR tensor as any other,
so it moves the group once ``set_epoch`` makes the LR non-zero.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

_UNPORTED = '(ROADMAP queue 1, "Training on the served backbones")'


class Optimizer:
    def __init__(self, config, params, loaded=()):
        """``params``: the model's parameters (the trainable ones are kept);
        ``loaded``: those of them restored from a pretraining run, finetuning's
        second group."""
        t = config.training
        self.name = t.optimizer
        self.base_lr = float(t.learning_rate)
        if self.name in ("ranger", "ranger21", "ranger_classic"):
            raise NotImplementedError(f"optimizer {self.name!r} is not ported {_UNPORTED}")
        if int(t.get("grad_accum_steps", 1) or 1) > 1:
            raise NotImplementedError(f"training.grad_accum_steps > 1 is not ported {_UNPORTED}")
        scheduler = t.get("lr_scheduler")
        if scheduler not in (None, "none", "constant", "cosine", "linear"):
            raise ValueError(f"Invalid scheduler selection: {scheduler}")
        self.schedule = scheduler if scheduler in ("cosine", "linear") else "constant"
        self.total_epochs = int(t.get("epochs", 1) or 1)
        self.lr_min_factor = float(t.get("lr_min_factor", 0.0) or 0.0)
        self.lr_warmup_epochs = int(t.get("lr_warmup_epochs", 0) or 0)
        self.clip_norm = float(t.get("grad_clip_norm", 0.0) or 0.0)

        self.params = [p for p in params if p.requires_grad]
        loaded_ids = {id(p) for p in loaded}
        groups = ([p for p in self.params if id(p) not in loaded_ids],
                  [p for p in self.params if id(p) in loaded_ids])
        self.has_loaded = bool(groups[1])
        ft = config.get("finetuning", {})
        enabled = bool(ft.get("enabled", False)) and self.has_loaded
        self.frozen_epochs = int(ft.get("frozen_epochs", 0) or 0) if enabled else 0
        self.warmup_epochs = int(ft.get("warmup_epochs", 0) or 0) if enabled else 0
        if self.frozen_epochs and self.warmup_epochs:
            raise ValueError("finetuning.frozen_epochs and finetuning.warmup_epochs are "
                             "mutually exclusive")
        if self.warmup_epochs:
            self.warmup_factors = np.linspace(float(ft.warmup_factor), 1.0,
                                              self.warmup_epochs)

        device = self.params[0].device if self.params else torch.device("cpu")
        self.on_device = device.type == "cuda"
        self.lr = torch.tensor(self.base_lr, dtype=torch.float32, device=device)
        self.loaded_lr = torch.tensor(self.base_lr, dtype=torch.float32, device=device)
        # (params, the group's LR tensor): the new group, then the loaded one
        self._groups = [(g, lr) for g, lr in zip(groups, (self.lr, self.loaded_lr)) if g]
        param_groups = [{"params": g, "lr": lr if self.on_device or self.name == "sgd"
                         else self.base_lr} for g, lr in self._groups]
        match self.name:
            case "adam":
                self._opt = torch.optim.Adam(param_groups, betas=(0.9, 0.999),
                                             eps=1e-8, capturable=self.on_device)
            case "adamw":
                self._opt = torch.optim.AdamW(param_groups, betas=(0.9, 0.999),
                                              eps=1e-8, weight_decay=0.01,
                                              capturable=self.on_device)
            case "sgd":
                self._opt = DeviceLRSGD(param_groups, lr=self.lr, momentum=0.9)
            case _:
                raise ValueError(f"Invalid optimizer selection: {self.name}")
        self.last_lrs = [self.base_lr, self.base_lr] if self.has_loaded else [self.base_lr]

    def loaded_factor(self, epoch: int) -> float:
        """The loaded group's own LR factor (0-based epoch): 0 through
        ``frozen_epochs``, or the warmup ramp, then 1."""
        if self.frozen_epochs > 0:
            return 0.0 if epoch < self.frozen_epochs else 1.0
        if self.warmup_epochs > 0:
            return (float(self.warmup_factors[epoch]) if epoch < self.warmup_epochs
                    else 1.0)
        return 1.0

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
        """The epoch's LRs, written into ``lr`` and ``loaded_lr`` in place (on
        a card, on the current stream: after every step enqueued before it)."""
        sched = self.schedule_factor(epoch)
        self.last_lrs = [self.base_lr * sched]
        if self.has_loaded:
            self.last_lrs.append(self.base_lr * sched * self.loaded_factor(epoch))
        self.lr.fill_(self.last_lrs[0])
        self.loaded_lr.fill_(self.last_lrs[-1])
        for group, (_, lr) in zip(self._opt.param_groups, self._groups):
            if not isinstance(group["lr"], torch.Tensor):  # Adam on the CPU
                group["lr"] = self.last_lrs[-1] if lr is self.loaded_lr else self.last_lrs[0]

    def get_last_lr(self) -> list[float]:
        return list(self.last_lrs)

    def zero_grad(self) -> None:
        self._opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip (one global norm over every gradient, in f32; scale
        min(1, max_norm / max(norm, 1e-16)) as ``clip_global_norm_float``),
        then update. Nothing is read back to the host: whether there are
        gradients to clip is a choice made in Python."""
        if self.clip_norm > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            if grads:
                norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
                scale = (self.clip_norm / norm.clamp(min=1e-16)).clamp(max=1.0)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
        with warnings.catch_warnings():
            # a capturable optimizer stepped outside a capture (the warm-up
            # of each captured step, the eager step beside it) is meant
            warnings.filterwarnings("ignore", message=r".*running without CUDA graph capture")
            self._opt.step()


class DeviceLRSGD(torch.optim.Optimizer):
    """``torch.optim.SGD(momentum=m, nesterov=True)``'s multi-tensor update
    with the learning rate read from a tensor on the parameters' device
    (a Python number works too).
    torch's SGD reads a tensor LR back to the host (``alpha=-lr``), so a
    captured step would keep its first value; here the last operation is
    ``p -= g * lr`` on the device. The rest is torch's, in its order: the
    first step's buffer is a copy of the gradient, later ones
    ``buf * m + g``; then the step's direction ``g + m * buf`` (the
    gradient itself stays as it is)."""

    def __init__(self, params, lr: torch.Tensor, momentum: float):
        super().__init__(params, {"lr": lr, "momentum": momentum})

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            m = group["momentum"]
            if all("momentum_buffer" in s for s in states):
                bufs = [s["momentum_buffer"] for s in states]
                torch._foreach_mul_(bufs, m)
                torch._foreach_add_(bufs, grads)
            else:
                for s, g in zip(states, grads):
                    if "momentum_buffer" in s:
                        s["momentum_buffer"].mul_(m).add_(g)
                    else:
                        s["momentum_buffer"] = g.detach().clone()
                bufs = [s["momentum_buffer"] for s in states]
            step = torch._foreach_add(grads, bufs, alpha=m)
            torch._foreach_mul_(step, group["lr"])
            torch._foreach_sub_(params, step)
