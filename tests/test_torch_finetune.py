"""Pretraining -> finetuning transfer in the port against the JAX package's
(``tests/test_medtsllm.py::test_pretraining_then_finetune``), on the CPU:

  (a) a finetune trainer restores a pretraining run's checkpoint: the
      loaded set is JAX's ``loaded_params`` (through ``from_flax`` names),
      ``output_projection`` is not among it, the loaded tensors equal the
      checkpoint's bit for bit, and ``train()`` runs with two LRs, logging
      ``train/finetune_lr``;
  (b) ``get_last_lr()`` epoch by epoch equal to JAX's optimizer's for
      ``frozen_epochs = 1`` and ``warmup_epochs = 2``, under the constant
      and cosine schedules, each LR written in place into its tensor;
  (c) a frozen epoch under Adam leaves the loaded tensors bit-equal while
      their moments advance;
  (d) three SGD steps across the frozen -> unfrozen boundary against JAX's
      jitted ``train_step`` on the same weights and batches: the losses and
      every trainable tensor within 1e-5 in f32 (SGD, for the reason
      tests/test_torch_train.py gives: Adam moves a near-zero gradient's
      element by about lr on rounding alone);
  (e) the refusals: ``frozen_epochs`` with ``warmup_epochs`` (JAX's
      message), a missing pretraining checkpoint (its path named).

Sizes: tests/test_torch_pretraining.py's (llama-tiny, two layers, history
32, batch 4, the mixture at 0.3 %), two features on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.config import ConfigError as JaxConfigError
from medtsllm_tpu.config import validate_config as jax_validate_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.runtime.optim import Optimizer as JaxOptimizer
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.config import Config, ConfigError, validate_config
from medtsllm_tpu_torch.runtime import checkpoint as ckpt
from medtsllm_tpu_torch.runtime.optim import Optimizer
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

_MODEL = {"medtsllm": {
    "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
    "covariate_mode": "concat", "embedding_downsample_mode": "linear",
    "patching": {"patch_len": 8, "stride": 4},
    "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                  "examples": False, "input_stats_dim": 0, "input_stats_select": "all"},
    "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2, "prefix_cache": True,
            "load_in_4bit": False, "load_in_8bit": False}}}


def _cfg(logdir, task, optimizer="sgd", lr=1e-2, epochs=2, **finetuning):
    cfg = make_config(task=task, model="medtsllm", hist=32, pred=32, step=16, loss="mse")
    cfg["paths"] = {"logdir": str(logdir)}
    cfg.training.batch_size, cfg.training.epochs = 4, epochs
    cfg.training.optimizer, cfg.training.learning_rate = optimizer, lr
    cfg["models"] = _MODEL
    if task == "pretraining":
        cfg["tasks"]["pretraining"] = {"downsample_pct": 0.003, "n_features": 2}
    else:
        cfg.datasets.synthetic.n_points = 200
        cfg.datasets.synthetic.n_features = 2
    if finetuning:
        cfg["finetuning"] = {"enabled": True, "pretrained_id": "pre",
                             "pretrained_ckpt": "latest", **finetuning}
    return cfg


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """JAX's pretraining trainer and the port's on its weights, each saving
    ``latest`` of run "pre" under its own logdir (the port's file is
    torch's, JAX's msgpack): (JAX logdir, port logdir, the port's
    checkpoint)."""
    root = tmp_path_factory.mktemp("runs")
    jdir, tdir = root / "jax", root / "port"
    jt = jax_get_trainer("pre", _cfg(jdir, "pretraining"))
    jt.logger.save_state("latest", async_=False)
    tt = get_trainer("pre", _cfg(tdir, "pretraining"), device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    tt.logger.save_state("latest", async_=False)
    saved, _ = ckpt.load_checkpoint(tdir / "pre" / "checkpoints" / "latest.ckpt")
    return jdir, tdir, saved


def _flax_names(paths, params) -> set:
    """JAX's "/"-paths of ``params`` -> the port's state-dict names."""
    tree = {}
    for path in paths:
        keys, node, leaf = path.split("/"), tree, params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        for k in keys:
            leaf = leaf[k]
        node[keys[-1]] = np.asarray(leaf)
    return set(from_flax(tree))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# --------------------------------------------------------------------------
# (a) the loaded set, train()
# --------------------------------------------------------------------------

def test_finetune_loads_jax_set_and_trains(pretrained, capsys):
    """JAX's flow: the finetune trainer restores the pretraining run's
    ``latest`` without its output head; the port's loaded set is JAX's,
    its tensors the checkpoint's, bit for bit (in place: the parameters
    keep their addresses); ``train()`` (warmup 1 epoch at 0.1) runs with
    two LRs and logs ``train/finetune_lr``."""
    jdir, tdir, saved = pretrained
    ft = dict(warmup_epochs=1, warmup_factor=0.1)
    jt = jax_get_trainer("ft", _cfg(jdir, "reconstruction", "adam", 1e-3, **ft))
    tt = get_trainer("ft", _cfg(tdir, "reconstruction", "adam", 1e-3, **ft), device="cpu")
    assert jt.finetuning and tt.finetuning
    want = _flax_names(jt.loaded_params, jax.device_get(jt.params))
    assert set(tt.loaded_params) == want and len(want) > 0
    assert not any(n.startswith("output_projection") for n in tt.loaded_params)
    assert set(saved) - want == {n for n in saved if n.startswith("output_projection")}
    state = tt.model.state_dict()
    for n in tt.loaded_params:
        assert state[n].dtype == saved[n].dtype and torch.equal(state[n], saved[n]), n
    loaded = {id(p) for n, p in tt.model.named_parameters() if n in set(tt.loaded_params)}
    assert {id(p) for p in tt.optimizer._opt.param_groups[1]["params"]} == loaded
    tt.train()
    jlrs, tlrs = jt.optimizer.get_last_lr(), tt.optimizer.get_last_lr()
    assert len(tlrs) == 2 and tlrs == pytest.approx(jlrs, rel=1e-12)
    assert "'train/finetune_lr': " in capsys.readouterr().out
    assert np.isfinite(tt.losses).all() and tt.epoch == 3
    tt.log_end()


# --------------------------------------------------------------------------
# (b) the two LRs per epoch
# --------------------------------------------------------------------------

_SCHEDULES = {"constant": dict(lr_scheduler="constant"),
              "cosine": dict(lr_scheduler="cosine", lr_min_factor=0.1)}
_FINETUNE = {"frozen": dict(frozen_epochs=1), "warmup": dict(warmup_epochs=2, warmup_factor=0.1)}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
@pytest.mark.parametrize("mode", sorted(_FINETUNE))
def test_finetune_lrs_match_jax(tmp_path, mode, schedule, opt):
    """``get_last_lr()`` over five epochs equals JAX's optimizer's on a
    two-group label tree (new, loaded), and each LR lands in its own tensor
    in place (``lr`` / ``loaded_lr``: what a captured step reads); on the
    CPU Adam's groups take them as numbers."""
    cfg = _cfg(tmp_path, "reconstruction", opt, 1e-3, epochs=5, **_FINETUNE[mode])
    for k, v in _SCHEDULES[schedule].items():
        cfg.training[k] = v
    jopt = JaxOptimizer(cfg, {"a": "new", "b": "loaded"}, num_iterations=10)
    jstate = jopt.init({"a": jnp.zeros(2), "b": jnp.zeros(2)})
    a, b = torch.zeros(2, requires_grad=True), torch.zeros(2, requires_grad=True)
    topt = Optimizer(Config(cfg.to_dict()), [a, b], loaded=[b])
    assert topt.get_last_lr() == jopt.get_last_lr() == [1e-3, 1e-3]
    addr = (topt.lr.data_ptr(), topt.loaded_lr.data_ptr())
    seen = []
    for epoch in range(5):
        jstate = jopt.set_epoch(jstate, epoch)
        topt.set_epoch(epoch)
        want = jopt.get_last_lr()
        assert topt.get_last_lr() == pytest.approx(want, rel=1e-12, abs=0.0), epoch
        assert (topt.lr.item(), topt.loaded_lr.item()) == (np.float32(want[0]),
                                                           np.float32(want[1]))
        groups = [g["lr"] for g in topt._opt.param_groups]
        if opt == "adam":
            assert groups == topt.get_last_lr()
        else:
            assert groups[0] is topt.lr and groups[1] is topt.loaded_lr
        seen.append(want[1] / want[0])
    assert (topt.lr.data_ptr(), topt.loaded_lr.data_ptr()) == addr
    assert seen[0] == pytest.approx(0.0 if mode == "frozen" else 0.1)
    assert seen[-1] == pytest.approx(1.0)


# --------------------------------------------------------------------------
# (c) a frozen epoch under Adam, (d) three SGD steps against JAX
# --------------------------------------------------------------------------

def test_frozen_epoch_keeps_loaded_tensors_moves_moments(pretrained):
    """Adam in the frozen epoch (the loaded group's LR 0): after two train
    steps every loaded tensor is bit-equal to the checkpoint's, while its
    Adam moments and step count have advanced and the new group (the output
    head) has moved; in the next epoch the loaded tensors move."""
    _, tdir, saved = pretrained
    tt = get_trainer("frozen", _cfg(tdir, "reconstruction", "adam", 1e-3, frozen_epochs=1),
                     device="cpu")
    head = {n: p.detach().clone() for n, p in tt.model.named_parameters()
            if n.startswith("output_projection")}
    batches = [tt.train_model_inputs(b) for b, _ in zip(tt.train_pipeline, range(3))]
    tt.optimizer.set_epoch(0)
    assert tt.optimizer.get_last_lr() == [1e-3, 0.0]
    for a in batches[:2]:
        tt.train_step(a, a["valid"])
    params = dict(tt.model.named_parameters())
    for n in tt.loaded_params:
        assert torch.equal(params[n].detach(), saved[n]), n
        st = tt.optimizer._opt.state[params[n]]
        assert float(st["step"]) == 2 and bool((st["exp_avg"] != 0).any()), n
    assert all(not torch.equal(params[n].detach(), v) for n, v in head.items())
    tt.optimizer.set_epoch(1)
    tt.train_step(batches[2], batches[2]["valid"])
    moved = [n for n in tt.loaded_params if not torch.equal(params[n].detach(), saved[n])]
    assert len(moved) >= len(tt.loaded_params) - 1  # the key bias's gradient is ~0


def test_three_sgd_steps_across_unfreeze_match_jax(pretrained):
    """``frozen_epochs = 1``, SGD (momentum 0.9, nesterov) at 1e-2: two
    steps in the frozen epoch, then one in the next, against JAX's jitted
    ``train_step`` on the same weights and batches: each loss within 1e-5,
    every trainable tensor within 1e-5 after each step; the loaded tensors
    do not move in the frozen epoch in either package (the momentum
    buffers fill all the same, so the unfrozen step moves them by
    both)."""
    jdir, tdir, saved = pretrained
    jt = jax_get_trainer("sgd-ft", _cfg(jdir, "reconstruction", frozen_epochs=1))
    tt = get_trainer("sgd-ft", _cfg(tdir, "reconstruction", frozen_epochs=1), device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    for n in tt.loaded_params:  # JAX's finetune trainer loaded the same values
        assert torch.equal(tt.model.state_dict()[n], saved[n]), n
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    jpipe = JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=jt.config.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        epoch = 0 if step < 2 else 1
        state = jt.optimizer.set_epoch(state, epoch)
        tt.optimizer.set_epoch(epoch)
        assert tt.optimizer.get_last_lr() == pytest.approx(jt.optimizer.get_last_lr())
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-5)
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        for k in (k for k in got if not k.startswith("llm.")):
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step}: {k}")
        for n in tt.loaded_params:
            assert (torch.equal(got[n], saved[n]) and torch.equal(want[n], saved[n])) == (
                epoch == 0), (step, n)


# --------------------------------------------------------------------------
# (e) the refusals
# --------------------------------------------------------------------------

def test_finetune_refusals(tmp_path):
    """``frozen_epochs`` with ``warmup_epochs``: ``validate_config`` raises
    JAX's ConfigError message (and the optimizer, given such a config
    directly, refuses it too); a missing pretraining checkpoint raises
    naming its path; finetuning builds and trains, no longer refused."""
    cfg = _cfg(tmp_path, "reconstruction", frozen_epochs=1, warmup_epochs=1,
               warmup_factor=0.1)
    with pytest.raises(JaxConfigError) as jerr:
        jax_validate_config(cfg)
    with pytest.raises(ConfigError) as terr:
        validate_config(cfg)
    assert str(terr.value) == str(jerr.value)
    a, b = torch.zeros(1, requires_grad=True), torch.zeros(1, requires_grad=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Optimizer(Config(cfg.to_dict()), [a, b], loaded=[b])
    missing = _cfg(tmp_path, "reconstruction", frozen_epochs=1)
    missing.finetuning.pretrained_id = "nope"
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nope" / "checkpoints" /
                                                     "latest.ckpt")):
        get_trainer("ft-missing", missing, device="cpu")
