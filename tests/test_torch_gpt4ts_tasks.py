"""The four shipped files that name ``gpt4ts``
(``configs/baseline-models/{bidmc-gpt4ts,dreams,ecgmit-anom,ecgmit-seg}``)
in the port against the JAX package's trainers, on the CPU, each cut small
by the test's own copy: gpt2-tiny at 2 layers, d_model 16, d_ff 32, a
larger ``data.step``, batch 4, one epoch. (The modules alone are
tests/test_torch_gpt4ts.py's.)

  (d) the keys (the checkpoint holds the whole tree, as JAX's, which has
      no ``checkpoint_tree``), f32 eval on every test batch within 1e-5 x
      max(1, max |JAX|), and three SGD steps (momentum 0.9, nesterov, lr
      1e-2) at the dense f32 bounds of tests/test_torch_train.py (loss rtol
      1e-5, every parameter rtol 1e-4, atol 1e-5), with dropout 0 in the
      embedding and in the backbone (a copy of the gpt2-tiny preset with
      dropout 0, registered in both packages for this file: the backbone's
      0.1 is the preset's, not ``training.dropout``);
  (f) each file (its own dropout) through ``train()`` / ``test()`` and
      through the train and test CLIs' ``__main__`` with ``--device cpu``:
      finite losses, the task's score keys, the same test scores from both
      CLIs;
  (g) a local gpt2 snapshot (config.json and seeded weights written by the
      port's safetensors writer) loads into GPT4TS's backbone, one that
      cannot be read raises, none keeps the init with JAX's warning;
      MedTsLLM over gpt2 builds, and over a t5 snapshot's config.json
      builds the encoder-decoder (no prompt-head cache) and serves a batch.
"""

import contextlib
import dataclasses
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
from medtsllm_tpu.models.llm import loader as jax_loader
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.config import Config, dumps_toml
from medtsllm_tpu_torch.models.llm import config as port_llm_config
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
NODROP = "gpt2-tiny-nodrop"
SHIPPED = {name: ROOT / "configs" / "baseline-models" / f"{name}.toml"
           for name in ("bidmc-gpt4ts", "dreams", "ecgmit-anom", "ecgmit-seg")}
TASK_KEYS = {
    "forecasting": {"mse", "mae"},
    "anomaly_detection": {"accuracy", "f1", "auroc", "precision", "recall", "iou",
                          "recon_mse", "recon_mae", "anomaly_quantile", "anomaly_threshold"},
    "segmentation": {"point_mae", "point_rmse", "segment_miou", "pred_label_ratio",
                     "point_acc@50", "point_acc@100", "point_acc@200", "segment_acc@50iou",
                     "segment_acc@75iou", "segment_acc@90iou"},
}


@pytest.fixture(scope="module", autouse=True)
def nodrop_preset():
    """gpt2-tiny with dropout 0 under its own id, in both packages' presets
    for this file's life."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_loader.PRESETS, NODROP,
                   dataclasses.replace(jax_loader.PRESETS["gpt2-tiny"], dropout=0.0))
        mp.setitem(port_llm_config.PRESETS, NODROP,
                   dataclasses.replace(port_llm_config.PRESETS["gpt2-tiny"], dropout=0.0))
        yield


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, scale_tol):
    """|got - want| <= scale_tol x max(1, max |want|)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=scale_tol * max(1.0, float(np.abs(want).max())))


@contextlib.contextmanager
def jitted_flax_init():
    """flax ``Module.init`` under ``jax.jit`` while a JAX trainer is built
    (one compile in place of one per op; the same parameters)."""
    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, a: eager(self, r, *a, **kwargs))(rngs, args)
    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


# --------------------------------------------------------------------------
# (d) the shipped files against JAX's trainers
# --------------------------------------------------------------------------

def _raw(name: str, logdir, llm=NODROP) -> dict:
    """The test's copy of a shipped gpt4ts file: gpt2-tiny at 2 layers,
    d_model 16, d_ff 32, batch 4, data.step 512 (1024 for the 256-long
    windows), one epoch, the print logger under ``logdir``."""
    raw = tomllib.loads(SHIPPED[name].read_text())
    raw["models"]["gpt4ts"].update(llm=llm, gpt_layers=2, d_model=16, d_ff=32)
    raw["data"]["step"] = 1024 if raw["history_len"] >= 256 else 512
    raw["training"].update(epochs=1, batch_size=4)
    raw["setup"]["logger"] = "print"
    raw["paths"] = {"logdir": str(logdir)}
    return raw


@pytest.fixture(scope="module", params=sorted(SHIPPED))
def pair(request, tmp_path_factory):
    """(name, the config with dropout 0 and SGD at lr 1e-2, the JAX trainer,
    the port's on its weights)."""
    name = request.param
    raw = _raw(name, tmp_path_factory.mktemp("logs"))
    raw["training"].update(dropout=0.0, optimizer="sgd", learning_rate=1e-2)
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", JaxConfig(raw))
        tt = get_trainer("port", Config(raw), device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return name, raw, jt, tt


def test_keys_and_checkpoint_match_flax(pair):
    """(d) the keys and shapes of ``from_flax`` of JAX's tree; the checkpoint
    holds every one."""
    _, _, jt, tt = pair
    want = from_flax(jax.device_get(jt.params))
    got = tt.model.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert set(tt.checkpoint_params()) == set(want)


def test_eval_step_matches_jax(pair):
    """(d) every test batch, f32, 1e-5 x max(1, max |JAX|)."""
    _, _, jt, tt = pair
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
    """(d) three SGD steps on the same shuffled batches: each step's loss
    (rtol 1e-5) and every parameter after it (rtol 1e-4, atol 1e-5); the
    frozen ones do not move."""
    name, raw, jt, tt = pair
    params = jax.tree.map(jnp.array, jt.params)  # jt's own stay untouched
    state = jt.optimizer.init(params)
    frozen = {n: p.detach().clone() for n, p in tt.model.named_parameters()
              if not p.requires_grad}
    assert frozen and all(n.startswith("gpt2.") for n in frozen)
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
    state = tt.model.state_dict()
    assert all(torch.equal(state[n], v) for n, v in frozen.items())
    assert not tt.model.training


# --------------------------------------------------------------------------
# (f) train() / test() and the CLIs, (g) the refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_file_trains_and_tests_through_the_clis(tmp_path, monkeypatch, capsys, name):
    """(f) ``train()`` and ``test()`` with the file's own dropout (gpt2-tiny's
    0.1 in the backbone), then the file through the train CLI and the test
    CLI on its run directory, as ``python -m`` runs them: the same scores."""
    raw = _raw(name, tmp_path / "logs", llm="gpt2-tiny")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = get_trainer(f"{name}-run", Config(raw), device="cpu")
    tt.train()
    assert len(tt.losses) == len(tt.train_pipeline) > 0 and all(map(math.isfinite, tt.losses))
    scores = tt.test()
    assert set(scores) == {f"test/{k}" for k in TASK_KEYS[raw["task"]]}
    assert all(math.isfinite(v) for v in scores.values()), scores
    tt.log_end()
    path = tmp_path / f"{name}.toml"
    path.write_text(dumps_toml(raw))

    def run(module: str, prefix: str, *args) -> dict:
        monkeypatch.setattr(sys, "argv", [module, *args, "--device", "cpu"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        out = capsys.readouterr().out
        line = next(ln for ln in out.splitlines() if ln.startswith(prefix))
        return eval(line[len(prefix):], {"__builtins__": {}, "nan": math.nan})

    trained = run("medtsllm_tpu_torch.train", "Test results:", str(path), f"cli-{name}")
    assert set(trained) == set(scores) and all(map(math.isfinite, trained.values()))
    again = run("medtsllm_tpu_torch.test", "Results:", f"cli-{name}", "test", "latest",
                str(tmp_path / "logs"))
    assert again == trained


def test_snapshot_found_is_refused(tmp_path):
    """(g) a local gpt2 snapshot found is loaded: GPT4TS's backbone holds its
    tensors (gpt2-tiny's widths, seeded, in HF's names); a snapshot whose
    file is cut short raises; without one the init stays, with JAX's
    warning."""
    from medtsllm_tpu_torch.models.llm.safetensors import save_safetensors
    raw = _raw("dreams", tmp_path / "logs", llm="gpt2-tiny")
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "config.json").write_text(
        '{"model_type": "gpt2", "vocab_size": 512, "n_embd": 64, "n_layer": 2, '
        '"n_head": 4, "n_inner": 128, "n_positions": 512}')
    rng = np.random.default_rng(0)
    shapes = {"wte.weight": (512, 64), "wpe.weight": (512, 64), "ln_f.weight": (64,),
              "ln_f.bias": (64,)}
    for i in range(2):
        shapes.update({f"h.{i}.ln_1.weight": (64,), f"h.{i}.ln_1.bias": (64,),
                       f"h.{i}.ln_2.weight": (64,), f"h.{i}.ln_2.bias": (64,),
                       f"h.{i}.attn.c_attn.weight": (64, 192), f"h.{i}.attn.c_attn.bias": (192,),
                       f"h.{i}.attn.c_proj.weight": (64, 64), f"h.{i}.attn.c_proj.bias": (64,),
                       f"h.{i}.mlp.c_fc.weight": (64, 128), f"h.{i}.mlp.c_fc.bias": (128,),
                       f"h.{i}.mlp.c_proj.weight": (128, 64), f"h.{i}.mlp.c_proj.bias": (64,)})
    hf = {k: rng.normal(0, 0.02, v).astype(np.float32) for k, v in shapes.items()}
    save_safetensors(snap / "model.safetensors", hf)
    raw["paths"]["llm_path"] = str(snap)
    tt = get_trainer("snap", Config(raw), device="cpu")
    state = tt.model.state_dict()
    np.testing.assert_array_equal(state["gpt2.wte"].numpy(), hf["wte.weight"])
    np.testing.assert_array_equal(state["gpt2.blocks.1.attn.c_attn.weight"].numpy(),
                                  hf["h.1.attn.c_attn.weight"].T)
    np.testing.assert_array_equal(state["gpt2.blocks.0.ln_2.bias"].numpy(),
                                  hf["h.0.ln_2.bias"])
    data = (snap / "model.safetensors").read_bytes()
    (snap / "model.safetensors").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cannot be read"):
        get_trainer("snap", Config(raw), device="cpu")
    raw["paths"].pop("llm_path")
    with pytest.warns(UserWarning, match="no local weights found"):
        get_trainer("nosnap", Config(raw), device="cpu")


def test_medtsllm_over_gpt2_refused(tmp_path):
    """(g) MedTsLLM over gpt2 builds (the ln family is ported, its prompt
    head cached); over a t5 snapshot's config.json (no weights: the seeded
    init) it builds the encoder-decoder, with no prompt-head cache, and
    serves a finite batch."""
    from conftest import make_config
    from medtsllm_tpu_torch.models.llm.transformer import TransformerEncDec
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "gpt2-tiny", "llm_layers": -1}}}
    tt = get_trainer("x", cfg, device="cpu")
    assert tt.model.supports_prefix_cache and tt.model.llm_cfg.style == "gpt2"
    (tmp_path / "t5").mkdir()
    (tmp_path / "t5" / "config.json").write_text(
        '{"model_type": "t5", "vocab_size": 512, "d_model": 64, "d_kv": 16, "d_ff": 128, '
        '"num_layers": 2, "num_heads": 4, "feed_forward_proj": "gated-gelu"}')
    cfg.models.medtsllm.llm.llm = str(tmp_path / "t5")
    with pytest.warns(UserWarning, match="no local weights found"):
        tt = get_trainer("x", cfg, device="cpu")
    assert isinstance(tt.model.llm, TransformerEncDec) and tt.model.llm_cfg.t5_gated
    assert not tt.model.supports_prefix_cache
    batch = next(iter(tt.test_pipeline))
    out = tt.eval_dispatch(batch).numpy()
    assert out.shape == (4, 32, 3) and np.isfinite(out).all()
