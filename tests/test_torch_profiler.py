"""The port's tracing and NaN checks (``runtime/profiler.py``) and the
trainer's ``setup.profile_dir`` / ``setup.debug_nans`` hooks, on the CPU at
``llama-tiny``:

  (a) ``train()`` with ``profile_dir`` writes one Chrome trace of step 2
      (counted from 0, as JAX's trainer traces it), whose events name the
      step's ops; without the key no trace is taken;
  (b) ``debug_nans``: a clean train and eval step pass; a batch with a NaN
      raises ``FloatingPointError`` in the train step (its loss and the
      updated parameters) and in the eval step (its output), as
      ``jax_debug_nans`` stops JAX's trainer; unset, the same batch runs
      with no check at all (``check_finite`` never called);
  (c) the module's pieces: ``configure_from``, ``trace(None)``,
      ``check_finite``, ``StepTimer``.
"""

import contextlib
import json
import warnings

import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu_torch.runtime import profiler
from medtsllm_tpu_torch.tasks import get_trainer

torch.set_num_threads(1)


def _cfg(tmp_path, **setup):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.epochs = 1
    cfg.datasets.synthetic.n_points = 192
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False, "load_in_8bit": True}}}
    for key, value in setup.items():
        cfg.setup[key] = value
    return cfg


def _trainer(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_trainer("port", cfg, device="cpu")


def test_profile_dir_traces_step_2(tmp_path, monkeypatch):
    traced = []
    trace = profiler.trace

    def spy(profile_dir, *a, **kw):
        traced.append(profile_dir)
        return trace(profile_dir, *a, **kw)
    monkeypatch.setattr(profiler, "trace", spy)
    out = tmp_path / "profile"
    tr = _trainer(_cfg(tmp_path, profile_dir=str(out)))
    assert len(tr.train_pipeline) >= 3
    with contextlib.redirect_stdout(None):
        tr.train()
    assert traced == [None, None, str(out)] + [None] * (len(tr.train_pipeline) - 3)
    files = list(out.iterdir())
    assert [f.name for f in files] == [profiler.TRACE_NAME]
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the step's forward and backward: K1's plain quantizer and the optimizer
    assert any(n.startswith("aten::") for n in names)
    assert any("Optimizer.step" in n for n in names)
    tr = _trainer(_cfg(tmp_path))
    assert tr.profile_dir is None


def test_debug_nans_raises_on_a_nan_step(tmp_path, monkeypatch):
    tr = _trainer(_cfg(tmp_path, debug_nans=True))
    assert tr.debug_nans
    batch = next(iter(tr.train_pipeline))
    a = tr.train_model_inputs(batch)
    assert np.isfinite(float(tr.train_step(a, a["valid"])))  # clean: passes
    assert torch.isfinite(tr.eval_dispatch(next(iter(tr.test_pipeline)))).all()
    bad = dict(batch)
    bad["x_enc"] = np.array(batch["x_enc"], copy=True)
    bad["x_enc"][0, 3, 0] = np.nan
    a = tr.train_model_inputs(bad)
    with pytest.raises(FloatingPointError, match="train step"):
        tr.train_step(a, a["valid"])
    tb = next(iter(tr.test_pipeline))
    tb = dict(tb, x_enc=np.array(tb["x_enc"], copy=True))
    tb["x_enc"][1, 0, 2] = np.nan
    with pytest.raises(FloatingPointError, match="eval step"):
        tr.eval_dispatch(tb)
    # unset: the same NaN batch runs, no check made
    calls = []
    monkeypatch.setattr(profiler, "check_finite", lambda *a: calls.append(a))
    tr = _trainer(_cfg(tmp_path))
    assert not tr.debug_nans
    a = tr.train_model_inputs(bad)
    assert np.isnan(float(tr.train_step(a, a["valid"])))
    assert torch.isnan(tr.eval_dispatch(tb)).any()
    assert calls == []


def test_profiler_pieces(tmp_path):
    assert profiler.configure_from(_cfg(tmp_path, debug_nans=True))
    assert not profiler.configure_from(_cfg(tmp_path))
    with profiler.trace(None):
        pass
    with profiler.trace(""):
        pass
    profiler.check_finite("x", torch.ones(3), [torch.zeros(2), None], None,
                          torch.arange(3))  # integers are never NaN
    with pytest.raises(FloatingPointError, match="NaN in the y"):
        profiler.check_finite("y", [torch.ones(2), torch.tensor([0.0, float("nan")])])
    timer = profiler.StepTimer(batch_size=8)
    assert timer.summary() == {}
    for _ in range(3):
        timer.start()
        timer.stop(sync_on=torch.ones(2, 2))
    s = timer.summary()
    assert s["steps"] == 2 and s["windows_per_sec"] > 0
