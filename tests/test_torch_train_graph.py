"""The captured train step's CPU side (``runtime/optim.py``,
``runtime/graph.py::TrainGraphs``, ``tasks/base.py::train_step``): what
the card's graph relies on, held on the CPU.

  (a) ``set_epoch`` writes the epoch's LR into the optimizer's LR tensor in
      place (the same tensor, the same address) with ``schedule_factor``'s
      value (constant, cosine, linear, warmup), JAX's schedule; Adam's
      groups on the CPU take it as a number;
  (b) ``DeviceLRSGD``, the port's SGD on every device (the LR read from
      that tensor), against ``torch.optim.SGD`` across LR changes;
  (c) the CPU ``train_step`` is the eager step, and ``TrainGraphs`` refuses
      the CPU;
  (d) three eager steps of Adam, AdamW and SGD with a cosine schedule (a
      new LR each step) and a clip that bites, against JAX's jitted
      ``train_step`` on ``from_flax`` weights, at dropout 0 (the two
      frameworks draw different masks);
  (e) at dropout 0.1, two seeded trainers' ``train()`` give the same
      losses;
  (f) ``train()`` reads each step's loss one deep, and the loss it holds is
      a tensor of its own: not the one the next step returns.

Tolerances are tests/test_torch_train.py's for dense f32 steps: losses
rtol 1e-5, trainable parameters rtol 1e-4, atol 1e-5. Adam and AdamW
divide each gradient element by its own magnitude, so each element moves
by about lr whatever its gradient, and an element whose gradient sits near
zero moves apart in the two packages by up to about lr on rounding alone:
they run at the shipped configs' 1e-4 (configs/datasets/*.toml), SGD at
tests/test_torch_train.py's 1e-2. The reprogramming key projection's
bias, whose exact gradient is zero (the softmax over keys ignores a
constant added to a query's scores), moves on rounding noise in both
packages under Adam: it is held to a move of at most lr a step instead.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.runtime.optim import Optimizer as JaxOptimizer
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.runtime.graph import TrainGraphs
from medtsllm_tpu_torch.runtime.optim import DeviceLRSGD, Optimizer
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import train_state  # noqa: E402

torch.set_num_threads(1)

_KEY_BIAS = "reprogramming_layer.key_projection.bias"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# --------------------------------------------------------------------------
# (a) set_epoch, (b) the port's SGD
# --------------------------------------------------------------------------

_SCHEDULES = {"constant": dict(lr_scheduler="constant"),
              "cosine": dict(lr_scheduler="cosine", lr_min_factor=0.1),
              "linear": dict(lr_scheduler="linear", lr_min_factor=0.2),
              "warmup": dict(lr_scheduler="cosine", lr_warmup_epochs=2)}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
def test_set_epoch_writes_the_lr_tensor_in_place(schedule, opt):
    """(a) each epoch's LR lands in the same tensor, at the same address,
    at f32 (the tensor's dtype) of base x ``schedule_factor`` (JAX's
    schedule within 1e-12); Adam's CPU groups and ``get_last_lr`` have it
    at full precision, SGD's group reads the tensor."""
    over = {f"training.{k}": v for k, v in _SCHEDULES[schedule].items()}
    cfg = make_config(**{"training.optimizer": opt, "training.learning_rate": 3e-3,
                         "training.epochs": 6, **over})
    w = torch.zeros(3, requires_grad=True)
    topt = Optimizer(Config(cfg.to_dict()), [w])
    jopt = JaxOptimizer(cfg, None, num_iterations=6)
    lr, ptr = topt.lr, topt.lr.data_ptr()
    assert lr.dtype == torch.float32 and lr.device == w.device and not topt.on_device
    seen = []
    for epoch in range(6):
        topt.set_epoch(epoch)
        want = 3e-3 * topt.schedule_factor(epoch)
        assert topt.schedule_factor(epoch) == pytest.approx(jopt.schedule_factor(epoch),
                                                            rel=1e-12, abs=1e-12)
        assert topt.lr is lr and lr.data_ptr() == ptr
        assert lr.item() == float(np.float32(want))
        assert topt.get_last_lr() == [want]
        # Adam's CPU groups hold the number, SGD's group the tensor itself
        assert all(g["lr"] is lr if opt == "sgd" else g["lr"] == want
                   for g in topt._opt.param_groups)
        seen.append(want)
    # warmup: 0.5, 1 at the warmup's end and 1 at the decay's start, then down
    assert len(set(seen)) == {"constant": 1, "warmup": 5}.get(schedule, 6)


def test_device_lr_sgd_matches_torch_sgd():
    """(b) ``DeviceLRSGD`` (the port's SGD: momentum 0.9, nesterov, the LR
    read from a tensor) against ``torch.optim.SGD`` over six steps with the
    LR changed in place after two and four: the momentum buffers and the
    gradients bit-equal; the parameters within one f32 rounding of |p| a
    step (p - round(g lr) against torch's p + (-lr) g)."""
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((6, 5), (5,))]
    ref = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    dev = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    lr = torch.tensor(1e-2)
    ref_opt = torch.optim.SGD(ref, lr=1e-2, momentum=0.9, nesterov=True)
    dev_opt = DeviceLRSGD(dev, lr=lr, momentum=0.9)
    for step in range(6):
        if step in (2, 4):
            lr.fill_(lr.item() * 0.5)
            ref_opt.param_groups[0]["lr"] = lr.item()
        for r, d in zip(ref, dev):
            g = torch.from_numpy(rng.standard_normal(r.shape).astype(np.float32))
            r.grad, d.grad = g.clone(), g.clone()
        ref_opt.step()
        dev_opt.step()
        for r, d in zip(ref, dev):
            assert torch.equal(r.grad, d.grad)
            assert torch.equal(ref_opt.state[r]["momentum_buffer"],
                               dev_opt.state[d]["momentum_buffer"])
            np.testing.assert_allclose(_np(d), _np(r), rtol=0,
                                       atol=(step + 1) * 2 ** -23 * float(r.abs().max()))
    assert len(dev_opt.state) == 2


# --------------------------------------------------------------------------
# (c) the CPU runs the eager step
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm="llama-tiny", dropout=0.0, **training):
    """tests/test_torch_train.py's config (dense f32, the head cached in the
    train step), with ``training`` overrides."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.dropout = dropout
    for k, v in training.items():
        cfg.training[k] = v
    cfg.datasets.synthetic.n_points = 200
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False,
                "load_in_8bit": False},
    }}
    return cfg


@pytest.mark.parametrize("llm", ["llama-tiny", "mamba-tiny"])
def test_cpu_train_step_is_the_eager_step(tmp_path, llm):
    """(c) on the CPU there are no train graphs: ``train_step`` and
    ``train_step_eager`` from two trainers of one config (dropout 0.1, so
    the generator advances too) give bit-equal losses, parameters,
    optimizer states and generator states over three steps; ``TrainGraphs``
    refuses a CPU device."""
    cfg = _cfg(tmp_path, llm, dropout=0.1, optimizer="adam", learning_rate=1e-3)
    a, b = (get_trainer(n, cfg, device="cpu") for n in ("a", "b"))
    assert a.train_graphs is None and a.step_graphs is None
    for batch, _ in zip(a.train_pipeline, range(3)):
        arrays = a.train_model_inputs(batch)
        la = a.train_step(arrays, arrays["valid"])
        lb = b.train_step_eager(arrays, arrays["valid"])
        assert torch.equal(la, lb) and not la.requires_grad
    for ta, tb in zip(train_state(a.optimizer), train_state(b.optimizer)):
        assert torch.equal(ta, tb)
    # each parameter, then its step count and two moments
    assert len(train_state(a.optimizer)) == 4 * len(a.optimizer.params)
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())
    with pytest.raises(ValueError, match="CUDA"):
        TrainGraphs(a._train_update, torch.device("cpu"), a.optimizer.params)


# --------------------------------------------------------------------------
# (d) three eager steps against JAX's jitted train_step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("logs"), optimizer="sgd", learning_rate=1e-2,
               lr_scheduler="cosine", lr_min_factor=0.1, epochs=3, grad_clip_norm=0.05)
    return cfg, jax_get_trainer("jax", cfg)


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
def test_three_eager_steps_match_jax_train_step(jax_trainer, opt):
    """(d) three steps on the same shuffled batches, the epoch (so the LR)
    advanced before each, the gradients clipped to a global norm of 0.05
    (the first gradient's is larger): each step's loss and every trainable
    parameter after it against JAX's jitted ``train_step`` with the same
    optimizer settings; the backbone does not move."""
    cfg, jt = jax_trainer
    lr = 1e-2 if opt == "sgd" else 1e-4
    for c in (cfg, jt.config):
        c.training.optimizer, c.training.learning_rate = opt, lr
    jt.optimizer = jt.build_optimizer()
    jt._compile_steps()  # the jitted step closes over the optimizer
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    backbone = {k: v.clone() for k, v in tt.model.state_dict().items()
                if k.startswith("llm.")}
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    clipped = False
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        state = jt.optimizer.set_epoch(state, step)
        tt.optimizer.set_epoch(step)
        assert tt.optimizer.get_last_lr() == pytest.approx(jt.optimizer.get_last_lr())
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        if step == 0:  # the clipped gradient's global norm is the bound
            norm = torch.stack([p.grad.norm() for p in tt.optimizer.params]).norm()
            clipped = abs(float(norm) - 0.05) <= 1e-5 * 0.05
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        for k in (k for k in got if not k.startswith("llm.")):
            if k == _KEY_BIAS and opt != "sgd":
                for side in (got[k], want[k]):
                    move = np.abs(_np(side) - _np(start[k])).max()
                    assert move <= (step + 1) * lr * 1.01, k
                continue
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{opt} step {step}: {k}")
    assert clipped  # the first step's gradient was scaled down to the bound
    for k, v in backbone.items():
        assert torch.equal(tt.model.state_dict()[k], v), k


# --------------------------------------------------------------------------
# (e) seeded dropout, (f) the loop's one-deep readback
# --------------------------------------------------------------------------

@pytest.mark.parametrize("llm", ["llama-tiny", "mamba-tiny"])
def test_seeded_trainers_repeat_their_losses_with_dropout(tmp_path, llm):
    """(e) at dropout 0.1 two trainers of one config (one seed) give the
    same ``train()`` losses, exactly, over two epochs; a trainer whose
    dropout generator is reseeded gives others."""
    cfg = _cfg(tmp_path, llm, dropout=0.1, optimizer="adam", learning_rate=1e-3, epochs=2)
    a, b, c = (get_trainer(n, cfg, device="cpu") for n in ("a", "b", "c"))
    c.dropout_generator.manual_seed(cfg.setup.seed + 1)
    for t in (a, b, c):
        t.train()
    assert len(a.losses) == 2 * len(a.train_pipeline) and all(np.isfinite(a.losses))
    assert a.losses == b.losses
    assert a.losses[0] != c.losses[0]


def test_train_loop_holds_a_distinct_pending_loss(tmp_path):
    """(f) ``train()`` logs step i's loss after step i + 1 is dispatched
    (one deep, the last after the loop), and what it logs is the very
    tensor step i returned, never the tensor a later step returned (on a
    card that is the graph's clone: the next replay overwrites the graph's
    own loss)."""
    tt = get_trainer("port", _cfg(tmp_path, optimizer="sgd", learning_rate=1e-2),
                     device="cpu")
    events, outs = [], []
    step, log = tt.train_step, tt.log_step

    def train_step(arrays, valid):
        outs.append(step(arrays, valid))
        events.append(("step", len(outs) - 1))
        return outs[-1]

    def log_step(loss, n_valid):
        i = next(i for i, o in enumerate(outs) if o is loss)
        assert all(loss.data_ptr() != o.data_ptr() for o in outs[i + 1:])
        events.append(("log", i))
        log(loss, n_valid)

    tt.train_step, tt.log_step = train_step, log_step
    tt.val = lambda: {"val/mse": 0.0, "val/mae": 0.0}
    tt.train()
    n = len(tt.train_pipeline)
    want = [("step", 0)]
    for i in range(1, n):
        want += [("step", i), ("log", i - 1)]
    assert events == want + [("log", n - 1)]
    assert tt.losses == [float(o) for o in outs]
