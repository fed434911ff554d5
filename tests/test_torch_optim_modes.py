"""The optimizer's training modes, the port against the JAX package on the
CPU: gradient accumulation, Ranger21 (and its alias ``ranger``) and
``ranger_classic`` (``lookahead(optax.radam)``).

  (a) ``runtime/optim.py::Optimizer`` against JAX's ``Optimizer`` (whose
      chain is ``grad_accumulation`` around the clip around
      ``multi_transform`` of the ``new`` and ``loaded`` groups, a frozen
      leaf ``set_to_zero``) on the same parameters and gradients: ten
      optimizer steps over four epochs of a per-epoch schedule, with and
      without the clip, with accumulation windows that span the epochs;
      Ranger21's schedule through its warmup and into its warmdown, RAdam's
      rectification switching on at step 6. Every parameter in f32 within
      1e-6 relative (atol 1e-7) for Ranger21; within 1e-5 (atol 2e-6) for
      adam and sgd (test_torch_train.py's bound: torch adds the update in one
      rounding, optax forms it first) and for ranger_classic: RAdam's
      rho_t = rho_inf - 2 t b2^t / (1 - b2^t) cancels ~2000 down to ~5, so
      the one-ulp gap between XLA's f32 ``pow`` and torch's grows ~400x in
      the rectifier (1.4e-6 seen at step 6);
  (b) Ranger21's parts (``adaptive_grad_clip``, ``centralize_gradient``,
      ``normalize_gradient``, ``ranger21_lr``) against JAX's on ranks 1-3
      and a 2-element tensor;
  (c) the accumulation's laws: K micro-steps equal one step on the mean
      gradient (JAX's ``test_grad_accumulation_matches_mean_grad_step``),
      no accumulator for a frozen tensor, the trainer's fail-fast and
      warning, and ``train()`` carrying a window across an epoch.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.runtime import optim as jopt
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.runtime import optim as topt
from medtsllm_tpu_torch.tasks import get_trainer

torch.set_num_threads(1)

SHAPES = {"w": (6, 5), "c": (3, 2, 4), "b": (5,), "s": (2,)}
LABELS = {"w": "new", "c": "new", "b": "loaded", "s": "new", "f": "frozen"}


def _cfg(opt, accum=1, clip=0.0, sched="none", lr=1e-2):
    cfg = make_config(**{"training.optimizer": opt, "training.learning_rate": lr,
                         "training.lr_scheduler": sched, "training.epochs": 4,
                         "training.lr_warmup_epochs": 1, "training.lr_min_factor": 0.1,
                         "training.grad_clip_norm": clip,
                         "training.grad_accum_steps": accum})
    cfg["finetuning"] = {"enabled": True, "warmup_epochs": 2, "warmup_factor": 0.1}
    return cfg


# --------------------------------------------------------------------------
# (a) the optimizers against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opt,accum,clip,sched", [
    ("ranger21", 1, 0.0, "none"), ("ranger21", 1, 0.5, "cosine"),
    ("ranger", 1, 0.0, "linear"), ("ranger21", 2, 0.3, "cosine"),
    ("ranger_classic", 1, 0.0, "none"), ("ranger_classic", 1, 0.5, "linear"),
    ("ranger_classic", 3, 0.0, "cosine"), ("adam", 3, 0.5, "cosine"),
    ("sgd", 2, 0.0, "linear")])
def test_optimizer_modes_match_jax(opt, accum, clip, sched):
    cfg = _cfg(opt, accum, clip, sched)
    tol = (dict(rtol=1e-6, atol=1e-7) if opt in ("ranger21", "ranger")
           else dict(rtol=1e-5, atol=2e-6))
    rng = np.random.default_rng(len(opt) + accum)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    init["f"] = np.ones(3, np.float32)
    n_steps, per_epoch = 10, 10 * accum // 4 + 1  # windows straddle the epochs
    jo = jopt.Optimizer(cfg, LABELS, num_iterations=12)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(LABELS[k] != "frozen")
          for k, v in init.items()}
    to = topt.Optimizer(Config(cfg.to_dict()), list(tp.values()), loaded=[tp["b"]],
                        num_iterations=12)
    assert len(to.params) == 4 and len(getattr(to, "_acc", [None] * 4)) == 4
    micro = 0
    for epoch in range(4):
        state = jo.set_epoch(state, epoch)
        to.set_epoch(epoch)
        assert to.get_last_lr() == pytest.approx(jo.get_last_lr())
        for _ in range(per_epoch):
            if micro == n_steps * accum:
                break
            grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in init.items() if k != "f"}
            updates, state = jo.update({**{k: jnp.asarray(g) for k, g in grads.items()},
                                        "f": jnp.zeros(3)}, state, jp)
            jp = optax.apply_updates(jp, updates)
            before = {k: t.detach().clone() for k, t in tp.items()}
            for k, g in grads.items():
                tp[k].grad = torch.from_numpy(g)
            window_end = to.applies()
            to.step()
            to.end_micro_step()
            micro += 1
            assert window_end == (micro % accum == 0)
            for k in init:
                if not window_end or k == "f":
                    assert torch.equal(tp[k].detach(), before[k]), k
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                           **tol, err_msg=f"{micro}: {k}")
    assert micro == n_steps * accum and to.mini_step == 0
    if opt.startswith("ranger"):  # the count advanced once a window, per group
        counts = [int(g["count"]) for g in to._opt.param_groups]
        assert counts == [n_steps, n_steps]


# --------------------------------------------------------------------------
# (b) Ranger21's parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 5), (3, 2, 4), (5,), (2,)])
def test_ranger21_parts_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 10).astype(np.float32)
    p[0] = 1e-4  # a unit whose parameter norm sits under AGC's floor
    tp, tg = torch.from_numpy(p), torch.from_numpy(g)
    for clip in (1e-2, 10.0):
        np.testing.assert_allclose(topt.adaptive_grad_clip(tp, tg, clip).numpy(),
                                   np.asarray(jopt.adaptive_grad_clip(p, g, clip)),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(topt.centralize_gradient(tg).numpy(),
                               np.asarray(jopt.centralize_gradient(jnp.asarray(g))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(topt.normalize_gradient(tg).numpy(),
                               np.asarray(jopt.normalize_gradient(jnp.asarray(g))),
                               rtol=1e-6, atol=1e-7)


def test_ranger21_schedule_matches_jax():
    """Warmup, flat and warmdown to min_lr, at every step of a 60-step run."""
    for steps in range(1, 61):
        want = jopt.ranger21_lr(jnp.float32(steps), jnp.float32(1e-2), 14, 43, 17, 3e-5)
        got = topt.ranger21_lr(torch.tensor(float(steps)), torch.tensor(1e-2), 14, 43, 17,
                               3e-5)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_ranger21_needs_num_iterations():
    with pytest.raises(ValueError, match="num_iterations"):
        topt.Optimizer(Config(_cfg("ranger21").to_dict()),
                       [torch.zeros(2, requires_grad=True)])


# --------------------------------------------------------------------------
# (c) the accumulation's laws and the trainer
# --------------------------------------------------------------------------

def test_accumulation_is_the_mean_gradient_step():
    """Two Adam micro-steps under grad_accum_steps = 2 equal one step on the
    mean gradient; the first moves nothing; the frozen tensor has no
    accumulator."""
    def make(accum):
        w = torch.ones(4, requires_grad=True)
        f = torch.ones(3)
        return w, topt.Optimizer(Config(make_config(**{
            "training.optimizer": "adam", "training.learning_rate": 1e-2,
            "training.grad_accum_steps": accum}).to_dict()), [w, f])
    w, opt = make(2)
    assert [a.shape for a in opt._acc] == [(4,)]
    for g in (0.5, 1.5):
        w.grad = torch.full((4,), g)
        opt.step()
        opt.end_micro_step()
        if g == 0.5:
            assert torch.equal(w.detach(), torch.ones(4))
    ref, ref_opt = make(1)
    ref.grad = torch.full((4,), 1.0)
    ref_opt.step()
    torch.testing.assert_close(w, ref, rtol=1e-6, atol=0)


def _trainer_cfg(tmp_path, accum, epochs):
    cfg = make_config(**{"training.optimizer": "adam", "training.learning_rate": 1e-3,
                         "training.grad_accum_steps": accum, "training.epochs": epochs})
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg["models"] = {"dlinear": {"individual": False, "moving_avg": 13}}
    cfg.training.batch_size = 16
    cfg.datasets.synthetic.n_points = 160
    return cfg


def test_accumulation_in_the_trainer(tmp_path):
    """JAX's checks (a run shorter than one window raises; a dropped tail
    warns), then ``train()`` over two epochs of an odd batch count: the
    update ran once a window and the window's count crossed the epoch."""
    cfg = _trainer_cfg(tmp_path, 50, 1)
    with pytest.raises(ValueError, match="no optimizer step would ever fire"):
        get_trainer("a", cfg, device="cpu")
    probe = get_trainer("b", _trainer_cfg(tmp_path, 1, 1), device="cpu")
    per_epoch = len(probe.train_pipeline)
    assert per_epoch % 2
    cfg = _trainer_cfg(tmp_path, 2, 2)
    with pytest.warns(UserWarning, match="accumulate but never apply") if (
            2 * per_epoch) % 2 else warnings.catch_warnings():
        tt = get_trainer("c", cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    tt.train()
    total = 2 * per_epoch
    assert tt.optimizer.mini_step == total % 2
    steps = {int(s["step"]) for s in tt.optimizer._opt.state.values()}
    assert steps == {total // 2}
    assert any(not torch.equal(p, before[n]) for n, p in tt.model.named_parameters())
