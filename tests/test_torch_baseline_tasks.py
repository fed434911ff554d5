"""The baseline models of the port (DLinear, PatchTST, TimesNet and
FEDformer with Fourier and Wavelets) against the JAX package's, through
the tasks, on the CPU. Each of the eight shipped files that name one of
them runs on its family's stand-in, cut small by the test's own copy of
the file: fewer layers, narrower widths, larger ``data.step`` (fewer train
and val windows), one epoch. The multiwavelet blocks' c x k = 128 x 8
coefficients are fixed by FEDformer, not by the file, so that case keeps
them.

  (a) the port's state dict has the keys and shapes of ``from_flax`` of
      the JAX trainer's tree (every parameter, all trainable);
  (b) the f32 eval step on every test batch, on the JAX trainer's weights
      (``from_flax``), within 1e-5 x max(1, max |JAX|) of JAX's
      ``eval_step``;
  (c) three SGD steps (momentum 0.9, nesterov, lr 1e-2, dropout 0) on the
      same shuffled batches against JAX's ``train_step``, at the dense f32
      bounds of tests/test_torch_train.py: the loss rtol 1e-5, every
      parameter rtol 1e-4, atol 1e-5;
  (d) ``train()``, ``val()`` and ``test()`` through
      ``get_trainer(..., device="cpu")``: finite losses, the task's score
      keys, finite scores;
  (e) configs/config.toml through the train CLI's ``__main__`` (as
      ``python -m medtsllm_tpu_torch.train`` runs it) with ``--device
      cpu``, then the test CLI's on its run directory: the same test
      scores;
  (f) finetuning refused for a baseline, as JAX asserts; FEDformer's
      ``mode_select = "random"`` draws JAX's four index tuples. (GPT4TS,
      the fifth model of the registry, is tests/test_torch_gpt4ts.py's.)
"""

import contextlib
import json
import math
import runpy
import sys
import tomllib
import warnings
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.config import Config as JaxConfig
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.config import dumps_toml
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

# shipped file -> the cuts of the test's copy (dotted keys)
CASES = {
    "config": ("configs/config.toml", {"data.step": 256, "training.batch_size": 8}),
    "etth1-dlinear": ("configs/baseline-models/etth1-dlinear.toml",
                      {"data.step": 256, "training.batch_size": 8}),
    "psm-patchtst": ("configs/baseline-models/psm-patchtst.toml",
                     {"data.step": 1024, "training.batch_size": 4,
                      "models.patchtst.e_layers": 2, "models.patchtst.d_model": 16,
                      "models.patchtst.d_ff": 32, "models.patchtst.n_heads": 4}),
    "dreams-classification": ("configs/ablation/dreams-classification.toml",
                              {"data.step": 512, "training.batch_size": 4,
                               "models.patchtst.e_layers": 1, "models.patchtst.d_model": 16,
                               "models.patchtst.d_ff": 32, "models.patchtst.n_heads": 4}),
    "msl-timesnet": ("configs/baseline-models/msl-timesnet.toml",
                     {"data.step": 1000, "training.batch_size": 4,
                      "models.timesnet.e_layers": 1, "models.timesnet.d_model": 8,
                      "models.timesnet.d_ff": 8}),
    "etth1-imputation": ("configs/ablation/etth1-imputation.toml",
                         {"data.step": 512, "training.batch_size": 8,
                          "models.timesnet.e_layers": 1, "models.timesnet.d_model": 8,
                          "models.timesnet.d_ff": 8}),
    "msl-fedformer": ("configs/baseline-models/msl-fedformer.toml",
                      {"data.step": 1000, "training.batch_size": 4,
                       "models.fedformer.d_model": 16, "models.fedformer.d_ff": 32,
                       "models.fedformer.modes": 8}),
    "msl-fedformer-wavelets": ("configs/baseline-models/msl-fedformer-wavelets.toml",
                               {"data.step": 128, "training.batch_size": 32,
                                "models.fedformer.d_model": 16,
                                "models.fedformer.d_ff": 32}),
}
# each task's score keys (without the split's prefix)
TASK_KEYS = {
    "forecasting": {"mse", "mae"},
    "anomaly_detection": {"accuracy", "f1", "auroc", "precision", "recall", "iou",
                          "recon_mse", "recon_mae", "anomaly_quantile", "anomaly_threshold"},
    "classification": {"accuracy", "f1", "precision", "recall", "auroc"},
    "imputation": {"masked_mse", "masked_mae", "full_mse"},
    "reconstruction": {"mse", "mae"},
}


def _raw(name: str, logdir, epochs: int = 1) -> dict:
    """The test's copy of a shipped file: its cuts, one epoch, the print
    logger under ``logdir``."""
    path, cuts = CASES[name]
    raw = tomllib.loads((ROOT / path).read_text())
    for key, value in cuts.items():
        node = raw
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    raw["training"]["epochs"] = epochs
    raw["setup"]["logger"] = "print"
    raw["paths"] = {"logdir": str(logdir)}
    return raw


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, scale_tol):
    """|got - want| <= scale_tol x max(1, max |want|)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=scale_tol * max(1.0, float(np.abs(want).max())))


@contextlib.contextmanager
def jitted_flax_init():
    """flax ``Module.init`` under ``jax.jit`` while a JAX trainer is built:
    its eager init compiles each op apart (~150 compiles, ~30 s for
    TimesNet); one compile gives the same parameters, which the port then
    copies anyway."""
    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, a: eager(self, r, *a, **kwargs))(rngs, args)
    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


def jax_get_trainer_jitted(*args, **kwargs):
    """The JAX package's ``get_trainer`` with ``jitted_flax_init``."""
    with jitted_flax_init():
        return jax_get_trainer(*args, **kwargs)


def jax_trainer(raw: dict):
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_get_trainer("jax", JaxConfig(raw))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    """(name, the test's config with dropout 0 and SGD at lr 1e-2, the JAX
    trainer, the port's on its weights)."""
    name = request.param
    raw = _raw(name, tmp_path_factory.mktemp("logs"))
    raw["training"].update(dropout=0.0, optimizer="sgd", learning_rate=1e-2)
    jt = jax_trainer(raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = get_trainer("port", JaxConfig(raw), device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return name, raw, jt, tt


def test_state_dict_keys_match_flax(pair):
    """(a) the keys and shapes of ``from_flax`` of JAX's tree; every
    parameter trainable."""
    name, _, jt, tt = pair
    want = from_flax(jax.device_get(jt.params))
    got = tt.model.state_dict()
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert all(p.requires_grad for p in tt.model.parameters())
    assert set(tt.checkpoint_params()) == set(want)  # the checkpoint holds every one


def test_eval_step_matches_jax(pair):
    """(b) every test batch, f32, 1e-5 x max(1, max |JAX|)."""
    name, _, jt, tt = pair
    n = 0
    for jb, tb in zip(JaxBatchPipeline(jt.test_dataset, jt.config.training.batch_size),
                      tt.test_pipeline):
        want = jt.eval_step(jt.params, jt.eval_model_inputs(jb))
        got = tt.eval_dispatch(tb)
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want, 1e-5)
        n += 1
    assert n == len(tt.test_pipeline) > 0


def test_train_steps_match_jax(pair):
    """(c) three SGD steps on the same shuffled batches: each step's loss
    (rtol 1e-5) and every parameter after it (rtol 1e-4, atol 1e-5)."""
    name, raw, jt, tt = pair
    params = jax.tree.map(jnp.array, jt.params)  # jt's own stay untouched
    state = jt.optimizer.init(params)
    jpipe = JaxBatchPipeline(jt.train_dataset, raw["training"]["batch_size"], shuffle=True,
                             seed=raw["setup"]["seed"])
    steps = 0
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        want = from_flax(jax.device_get(params))
        for k, v in tt.model.state_dict().items():
            np.testing.assert_allclose(_np(v), _np(want[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} step {step}: {k}")
        steps += 1
    assert steps == 3
    assert not tt.model.training


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_val_test_through_get_trainer(tmp_path, name):
    """(d) ``train()`` (one epoch), ``val()`` and ``test()`` on the CPU."""
    raw = _raw(name, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = get_trainer(f"{name}-run", JaxConfig(raw), device="cpu")
    tt.train()
    assert len(tt.losses) == len(tt.train_pipeline) > 0
    assert all(math.isfinite(v) for v in tt.losses)
    keys = TASK_KEYS[raw["task"]]
    for split, scores in (("val", tt.val()), ("test", tt.test())):
        assert set(scores) == {f"{split}/{k}" for k in keys}
        nan = {f"{split}/auroc"} if raw["task"] == "classification" else set()
        assert all(math.isfinite(v) for k, v in scores.items() if k not in nan), scores
    tt.log_end()


def test_config_toml_through_the_clis(tmp_path, monkeypatch, capsys):
    """(e) configs/config.toml (DLinear forecasting on ETTh1) through the
    train CLI with ``--device cpu``, then the test CLI on its run
    directory, each run as ``python -m`` runs it (``runpy`` with
    ``__main__``, in this interpreter: a new one spends ~8 s importing
    torch and scipy): the test scores printed by both are equal."""
    raw = _raw("config", tmp_path / "logs")
    path = tmp_path / "config.toml"
    path.write_text(dumps_toml(raw))

    def run(module: str, prefix: str, *args) -> dict:
        monkeypatch.setattr(sys, "argv", [module, *args, "--device", "cpu"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        out = capsys.readouterr().out
        line = next(ln for ln in out.splitlines() if ln.startswith(prefix))
        return eval(line[len(prefix):], {"__builtins__": {}, "nan": math.nan})

    trained = run("medtsllm_tpu_torch.train", "Test results:", str(path), "cli-dlinear")
    assert set(trained) == {"test/mse", "test/mae"}
    assert all(math.isfinite(v) for v in trained.values())
    rundir = tmp_path / "logs" / "cli-dlinear"
    assert json.loads((rundir / "config.json").read_text())["model"] == "dlinear"
    assert (rundir / "checkpoints" / "latest.ckpt").is_file()
    again = run("medtsllm_tpu_torch.test", "Results:", "cli-dlinear", "test", "latest",
                str(tmp_path / "logs"))
    assert again == trained


def test_finetuning_refused_for_baselines(tmp_path):
    """(f) ``[finetuning]`` is MedTsLLM's: a baseline raises, as JAX's
    trainer asserts."""
    raw = _raw("config", tmp_path)
    raw["finetuning"] = {"enabled": True, "pretrained_id": "pre", "pretrained_ckpt": "latest"}
    with pytest.raises(ValueError, match="Only MedTsLLM supports finetuning"):
        get_trainer("ft", JaxConfig(raw), device="cpu")


def test_fedformer_random_modes_match_jax(tmp_path):
    """(f) ``mode_select = "random"`` (msl-fedformer.toml as shipped, its
    32 modes): the encoder, decoder and both cross-attention index tuples
    equal JAX's for the same config and seed; another seed draws others."""
    def modes(raw):
        jt = jax_trainer(raw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tt = get_trainer("port", JaxConfig(raw), device="cpu")
        names = ("index_enc", "index_dec", "index_cross_q", "index_cross_kv")
        return ([tuple(getattr(jt.model, n)) for n in names],
                [tuple(getattr(tt.model, n)) for n in names])

    raw = _raw("msl-fedformer", tmp_path)
    raw["models"]["fedformer"].update(d_model=16, d_ff=32, modes=32, e_layers=1)
    j0, t0 = modes(raw)
    assert t0 == j0 and all(len(ix) == 32 for ix in t0) and t0[0] != tuple(range(32))
    raw["setup"]["seed"] = 1
    j1, t1 = modes(raw)
    assert t1 == j1 and t1 != t0
