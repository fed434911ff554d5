"""The optimizer of the train step (port of ``medtsllm_tpu/runtime/optim.py``:
``Optimizer`` with adam, adamw, sgd, ranger21 / ranger and ranger_classic,
the per-epoch learning-rate schedules, the global-norm gradient clip,
gradient accumulation and finetuning's ``loaded`` group).

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

``ranger21`` (and ``ranger``, its alias, as in JAX) is ``Ranger21``, JAX's
own composition (``ranger21``, ``optim.py:192-428``) written out: adaptive
gradient clipping, centralization, normalization, positive-negative
momentum, the softplus denominator, stable weight decay, the norm loss, its
warmup / flat / warmdown schedule over ``num_iterations`` (the run's
micro-batches, ``len(train_pipeline) * epochs``, from the trainer) and its
lookahead. ``ranger_classic`` is ``RangerClassic``: ``optax.radam``'s rule
(rectification where rho_t >= 5, eps outside the square root; torch's
``RAdam`` takes rho_t > 5 and differs there) inside JAX's ``lookahead``.
Both keep their step count, and every value of their schedule, in tensors
on the parameters' device, one count a group (JAX's ``multi_transform``
gives each group a state of its own), so a captured step replays the whole
schedule.

``training.grad_accum_steps = K`` (JAX's ``grad_accumulation``): each
micro-step adds its gradients to an accumulator a trainable parameter
(``acc + g``, from zeros, in step order; frozen tensors and integer weights
have none); every K-th the gradients become ``acc / K``, which the clip and
the update see, and the accumulators return to zero. The update, its state
and its schedule advance only then. The window's position is a host count
(``mini_step``), advanced by ``end_micro_step`` after each step; windows
span epochs. ``applies()`` says whether the next step ends a window, and
the captured train step keeps one graph for each answer. No checkpoint
holds the optimizer's state, in either package, so the accumulators start
afresh with it.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

class Optimizer:
    def __init__(self, config, params, loaded=(), num_iterations: int | None = None):
        """``params``: the model's parameters (the trainable ones are kept);
        ``loaded``: those of them restored from a pretraining run, finetuning's
        second group; ``num_iterations``: the run's micro-batch count, which
        ranger21's schedule needs."""
        t = config.training
        self.name = t.optimizer
        self.base_lr = float(t.learning_rate)
        self.accum_steps = int(t.get("grad_accum_steps", 1) or 1)
        self.mini_step = 0
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
        device_lr = self.on_device or self.name in ("sgd", "ranger", "ranger21",
                                                     "ranger_classic")
        param_groups = [{"params": g, "lr": lr if device_lr else self.base_lr}
                        for g, lr in self._groups]
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
            case "ranger_classic":
                self._opt = RangerClassic(param_groups)
            case "ranger" | "ranger21":
                if num_iterations is None:
                    raise ValueError(
                        "ranger21 needs the total optimizer-step count for its "
                        "warmup/warmdown schedule (len(train_pipeline) * epochs); pass "
                        "num_iterations to Optimizer(...)")
                self._opt = Ranger21(param_groups, num_iterations)
            case _:
                raise ValueError(f"Invalid optimizer selection: {self.name}")
        self.last_lrs = [self.base_lr, self.base_lr] if self.has_loaded else [self.base_lr]
        if self.accum_steps > 1:
            self._acc = [torch.zeros_like(p, memory_format=torch.preserve_format)
                         for p in self.params]
            # a tensor divisor: true division, as XLA's a / every (see
            # quantize_rows_plain on division by a Python number on CUDA)
            self._every = torch.tensor(float(self.accum_steps), device=device)

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

    def applies(self) -> bool:
        """Whether the next ``step`` ends an accumulation window (always,
        without accumulation)."""
        return self.mini_step + 1 >= self.accum_steps

    def end_micro_step(self) -> None:
        """Advance the window's host count after a step (the trainer calls it
        after each train step, captured or not)."""
        if self.accum_steps > 1:
            self.mini_step = 0 if self.applies() else self.mini_step + 1

    def state_tensors(self) -> list:
        """Every tensor a step writes, detached (their storage shared): the
        trainable parameters, the update's state parameter by parameter and
        group by group, and the accumulators. A captured step reads and
        writes them where they lie, so a snapshot is restored with
        ``copy_``."""
        state = [t for p in self.params for t in self._opt.state.get(p, {}).values()
                 if isinstance(t, torch.Tensor)]
        groups = [v for g in self._opt.param_groups for k, v in g.items()
                  if k not in ("params", "lr") and isinstance(v, torch.Tensor)]
        return [t.detach() for t in (*self.params, *state, *groups,
                                     *getattr(self, "_acc", ()))]

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """Add this micro-step's gradients to the accumulators; at a window's
        end set each gradient to the mean and zero the accumulators. Returns
        whether the update runs."""
        for p, acc in zip(self.params, self._acc):
            if p.grad is not None:
                acc.add_(p.grad)
        if not self.applies():
            return False
        for p, acc in zip(self.params, self._acc):
            if p.grad is None:
                p.grad = acc / self._every
            else:
                torch.div(acc, self._every, out=p.grad)
            acc.zero_()
        return True

    def step(self) -> None:
        """With accumulation, accumulate (``_accumulate``) and stop there but
        at a window's end. Then clip (one global norm over every gradient, in
        f32; scale min(1, max_norm / max(norm, 1e-16)) as
        ``clip_global_norm_float``) and update. Nothing is read back to the
        host: whether there are gradients to clip is a choice made in
        Python."""
        if self.accum_steps > 1 and not self._accumulate():
            return
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


def _unit_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm per unit (output row): over all but dim 0 (kept, to
    broadcast back) for rank >= 2, over the whole tensor for rank <= 1."""
    if x.dim() <= 1:
        return x.square().sum().sqrt()
    return x.square().sum(dim=tuple(range(1, x.dim())), keepdim=True).sqrt()


def adaptive_grad_clip(p, g, clip: float = 1e-2, eps: float = 1e-3):
    """AGC: each unit's gradient norm clipped to ``clip`` x the unit's
    parameter norm (floored at ``eps``)."""
    max_norm = torch.clamp(_unit_norm(p), min=eps) * clip
    g_norm = _unit_norm(g)
    scaled = g * (max_norm / torch.clamp(g_norm, min=1e-6))
    return torch.where(g_norm > max_norm, scaled, g)


def centralize_gradient(g):
    """Zero mean over all but dim 0 (rank >= 2)."""
    if g.dim() <= 1:
        return g
    return g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)


def normalize_gradient(g, eps: float = 1e-8):
    """g / (population std + eps), tensors of more than 2 elements only."""
    if g.numel() <= 2:
        return g
    return g / (g.std(correction=0) + eps)


def ranger21_lr(stepf, lr, num_warmup: int, warmdown_start: int, num_warmdown: int,
                min_lr: float):
    """Ranger21's schedule (tensors in, a tensor out): linear warmup over
    ``num_warmup`` steps, flat, then linear warmdown to ``min_lr`` from
    ``warmdown_start`` over ``num_warmdown`` steps."""
    lr_warm = lr * torch.clamp(stepf / num_warmup, max=1.0)
    prog = torch.clamp((stepf - warmdown_start) / max(num_warmdown, 1), 0.0, 1.0)
    return torch.where(stepf > warmdown_start,
                       torch.clamp(lr_warm * (1.0 - prog) + min_lr * prog, min=min_lr),
                       lr_warm)


class Ranger21(torch.optim.Optimizer):
    """JAX's ``ranger21`` (``medtsllm_tpu/runtime/optim.py:274-428``) at its
    defaults, one state a group: per step, the gradient clipped per unit
    (AGC), centralized and normalized; the second moment and the global
    variance for stable weight decay; positive-negative momentum (two
    buffers updated on alternate steps); the softplus(beta 50) denominator;
    the norm loss; the schedule's LR; then every 5th step the lookahead
    toward the slow weights. The parameter moves by JAX's update, ``p + u``
    (``p + (slow' - p)`` on a lookahead step). The count, the LR and every
    value derived from them are tensors on the device."""

    def __init__(self, param_groups, num_iterations: int, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4, agc_clip: float = 1e-2,
                 agc_eps: float = 1e-3, norm_loss_factor: float = 1e-4, pnm_beta: float = 1.0,
                 beta_softplus: float = 50.0, min_lr: float = 3e-5,
                 lookahead_merge_time: int = 5, lookahead_alpha: float = 0.5):
        beta2 = float(betas[1])
        num_warmup = math.ceil(2.0 / (1.0 - beta2))
        if num_warmup > num_iterations:
            num_warmup = max(1, math.ceil(0.22 * num_iterations))
        num_warmdown = math.ceil(0.28 * num_iterations)
        self.hp = dict(beta1=float(betas[0]), beta2=beta2, eps=eps, wd=weight_decay,
                       agc_clip=agc_clip, agc_eps=agc_eps, nlf=norm_loss_factor,
                       pnm=pnm_beta, beta_sp=beta_softplus, min_lr=min_lr,
                       merge=lookahead_merge_time, alpha=lookahead_alpha,
                       num_warmup=num_warmup, num_warmdown=num_warmdown,
                       warmdown_start=max(num_iterations - num_warmdown, num_warmup),
                       noise_norm=math.sqrt((1.0 + pnm_beta) ** 2 + pnm_beta ** 2))
        super().__init__(param_groups, {})
        for group in self.param_groups:
            group["count"] = torch.zeros((), dtype=torch.int32,
                                         device=group["params"][0].device)
            for p in group["params"]:
                self.state[p] = {"pos_m": torch.zeros_like(p), "neg_m": torch.zeros_like(p),
                                 "nu": torch.zeros_like(p), "slow": p.detach().clone()}

    @torch.no_grad()
    def step(self) -> None:
        h = self.hp
        b1, b2 = h["beta1"], h["beta2"]
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            count = group["count"]
            step = count + 1
            stepf = step.float()
            bc1 = 1.0 - torch.pow(b1, stepf)
            bc2 = 1.0 - torch.pow(b2, stepf)
            conds, var_sum, n = [], torch.zeros((), device=count.device), 0
            for p in params:
                st = self.state[p]
                g = adaptive_grad_clip(p, p.grad, h["agc_clip"], h["agc_eps"])
                g = normalize_gradient(centralize_gradient(g))
                st["nu"].copy_(b2 * st["nu"] + (1.0 - b2) * g.square())
                conds.append(g)
                var_sum = var_sum + st["nu"].float().sum() / bc2
                n += p.numel()
            variance_normalized = torch.sqrt(torch.clamp(var_sum / max(n, 1), min=1e-12))
            lr = ranger21_lr(stepf, group["lr"], h["num_warmup"], h["warmdown_start"],
                             h["num_warmdown"], h["min_lr"])
            parity = (step % 2) == 1
            sync = (step % h["merge"]) == 0
            b1sq = b1 ** 2
            wd_scale = lr * h["wd"] / variance_normalized
            for p, g in zip(params, conds):
                st = self.state[p]
                pos, neg = st["pos_m"], st["neg_m"]
                new_pos = torch.where(parity, b1sq * pos + (1.0 - b1sq) * g, pos)
                new_neg = torch.where(parity, neg, b1sq * neg + (1.0 - b1sq) * g)
                cur = torch.where(parity, new_pos, new_neg)
                other = torch.where(parity, new_neg, new_pos)
                m_eff = ((1.0 + h["pnm"]) * cur - h["pnm"] * other) / h["noise_norm"]
                de_nom = torch.sqrt(st["nu"] / bc2) + h["eps"]
                x = h["beta_sp"] * de_nom
                de_nom = torch.logaddexp(x, torch.zeros_like(x)) / h["beta_sp"]
                correction = 2.0 * h["nlf"] * (1.0 - 1.0 / (_unit_norm(p) + h["eps"]))
                scale = (1.0 - wd_scale) * (1.0 - lr * correction)
                u = (p * (scale - 1.0) - (lr / bc1) * m_eff / de_nom).to(p.dtype)
                slow = st["slow"]
                new_slow = torch.where(sync, slow + h["alpha"] * (p + u - slow), slow)
                p.add_(torch.where(sync, new_slow - p, u))
                pos.copy_(new_pos)
                neg.copy_(new_neg)
                slow.copy_(new_slow)
            count.copy_(step)


class RangerClassic(torch.optim.Optimizer):
    """JAX's ``ranger_classic``, ``lookahead(optax.radam(lr))``
    (``optim.py:49-95``, ``:439-441``): RAdam at b1 0.9, b2 0.999, eps 1e-8
    (optax's ``scale_by_radam``: rectified where rho_t >= 5, else the
    bias-corrected momentum alone; eps added outside the square root),
    scaled by -lr, inside a lookahead of period 5 and step 0.5. The count
    and the LR are tensors on the device, one count a group."""

    def __init__(self, param_groups, betas=(0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0, sync_period: int = 5, slow_step: float = 0.5):
        self.hp = dict(b1=float(betas[0]), b2=float(betas[1]), eps=eps, threshold=threshold,
                       sync=sync_period, alpha=slow_step,
                       ro_inf=2.0 / (1.0 - float(betas[1])) - 1.0)
        super().__init__(param_groups, {})
        for group in self.param_groups:
            group["count"] = torch.zeros((), dtype=torch.int32,
                                         device=group["params"][0].device)
            for p in group["params"]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                                 "slow": p.detach().clone()}

    @torch.no_grad()
    def step(self) -> None:
        h = self.hp
        b1, b2, ro_inf = h["b1"], h["b2"], h["ro_inf"]
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            count = group["count"]
            step = count + 1
            stepf = step.float()
            b2t = torch.pow(b2, stepf)
            ro = ro_inf - 2 * stepf * b2t / (1 - b2t)
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                           / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            bc1, bc2 = 1 - torch.pow(b1, stepf), 1 - b2t
            sync = (step % h["sync"]) == 0
            neg_lr = -1 * group["lr"]
            for p in params:
                st = self.state[p]
                g = p.grad
                st["mu"].copy_((1 - b1) * g + b1 * st["mu"])
                st["nu"].copy_((1 - b2) * g.square() + b2 * st["nu"])
                mu_hat, nu_hat = st["mu"] / bc1, st["nu"] / bc2
                u = torch.where(ro >= h["threshold"],
                                r * mu_hat / (torch.sqrt(nu_hat) + h["eps"]), mu_hat)
                u = neg_lr * u
                slow = st["slow"]
                new_slow = torch.where(sync, slow + h["alpha"] * (p + u - slow), slow)
                p.add_(torch.where(sync, new_slow - p, u))
                slow.copy_(new_slow)
            count.copy_(step)
