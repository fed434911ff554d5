"""The serving slice as a whole: the JAX trainer and the port's trainer
built from one config (llama-tiny, prompt-head KV cache with
``cache_order``), the JAX parameters copied into the port, then compared
on the same test batches:
  (a) the PromptBuilder's prefix_ids and prompt_ids are equal;
  (b) the port's eval_dispatch equals JAX's eval_step on the same inputs;
  (c) the port's cached output equals its uncached output;
  (d) ReconstructionTask.test() scores agree.

Tolerances for (b)/(d): dense f32 projections differ only in summation
order (1e-5). With int8 projections a last-bit difference in an activation
can flip one int8 rounding, so up to 2e-3 relative. bf16 storage differs by
bf16 roundings: 3e-2 relative.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.data import get_dataset
from medtsllm_tpu_torch.device import resolve_device
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

_TOL = {(0, "float32"): 1e-5, (8, "float32"): 2e-3, (8, "bf16"): 3e-2}


def _cfg(tmp_path, quant, dtype):
    """tests/test_prefix_cache.py's serving config."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32,
                      step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 384
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False,
                "load_in_8bit": quant == 8},
    }}
    return cfg


@pytest.fixture(scope="module", params=sorted(_TOL))
def pair(request, tmp_path_factory):
    quant, dtype = request.param
    cfg = _cfg(tmp_path_factory.mktemp("logs"), quant, dtype)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt, _TOL[request.param]


def test_data_matches(pair):
    jt, tt, _ = pair
    assert len(jt.test_pipeline) == len(tt.test_pipeline)
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        for k in ("x_enc", "index", "valid"):
            np.testing.assert_array_equal(jb[k], tb[k])


def test_prompt_ids_equal(pair):
    """(a) the same prompt token ids, head and per-window suffix."""
    jt, tt, _ = pair
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
        assert ja["prefix_ids"].ndim == 1
        np.testing.assert_array_equal(ja["prefix_ids"], ta["prefix_ids"])
        np.testing.assert_array_equal(ja["prompt_ids"], ta["prompt_ids"])


def test_eval_dispatch_matches_jax_eval_step(pair):
    """(b) on every test batch."""
    jt, tt, tol = pair
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_cached_equals_uncached(pair):
    """(c) the prefix served from the KV cache reproduces the forward with
    the head embedded in-graph."""
    _, tt, _ = pair
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_model_inputs(batch)
    assert "prefix_kv" in cached and "prefix_ids" not in cached
    uncached = tt._to_device(tt.model_inputs(batch))
    np.testing.assert_allclose(tt.eval_step(cached).float().numpy(),
                               tt.eval_step(uncached).float().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_test_scores_match_jax(pair):
    """(d) ReconstructionTask.test() over the whole test split."""
    jt, tt, tol = pair
    want, got = jt.test(), tt.test()
    assert set(got) == {"test/mse", "test/mae"} == set(want)
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=tol)


def test_port_config_and_random_init(tmp_path):
    """The port's own Config drives it without the JAX package; random init
    is seeded (two trainers agree) and lands in the storage dtype."""
    cfg = Config(_cfg(tmp_path, 8, "bf16").to_dict())
    a, b = get_trainer("a", cfg, device="cpu"), get_trainer("b", cfg, device="cpu")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert sa["llm.blocks.0.attn.q_proj.weight_q"].dtype == torch.int8
    assert sa["llm.wte"].dtype == torch.bfloat16
    assert sa["mapping_layer.weight"].dtype == torch.bfloat16
    scores = a.test()
    assert all(np.isfinite(v) for v in scores.values())


def test_unported_options_raise(tmp_path):
    cfg = _cfg(tmp_path, 8, "float32")
    cfg.models.medtsllm.covariate_mode = "independent"  # ported: a row per channel
    tt = get_trainer("x", cfg, device="cpu")
    out = tt.eval_dispatch(next(iter(tt.test_pipeline)))
    assert out.shape == (4, 32, 3) and torch.isfinite(out).all()
    cfg = _cfg(tmp_path, 8, "float32")
    cfg.models.medtsllm.llm.fuse_projections = True
    with pytest.raises(NotImplementedError, match="fuse_projections"):
        get_trainer("x", cfg, device="cpu")
    cfg = _cfg(tmp_path, 8, "float32")
    cfg.task = "pretraining"  # ported: the mixture of the four families' stand-ins
    cfg["tasks"]["pretraining"] = {"downsample_pct": 0.002, "n_features": "auto"}
    pre = get_trainer("x", cfg, device="cpu")
    assert pre.test_dataset.dataset_names == ["ECG", "ventilator", "bidmc", "ludb"]
    assert "prefix_ids" not in pre.model_inputs(next(iter(pre.test_pipeline)))
    cfg = _cfg(tmp_path, 8, "float32")
    cfg.models.medtsllm.llm.llm = "gpt2"
    with pytest.raises(NotImplementedError, match="gpt2"):
        get_trainer("x", cfg, device="cpu")
    cfg = _cfg(tmp_path, 8, "float32")
    cfg.data.dataset = "ETTh1"  # ported: the ETT family (its stand-in here)
    assert type(get_dataset(cfg, "test")).__name__ == "ETTFamily"
    with pytest.raises(NotImplementedError, match="data.cols"):
        cfg.data.cols = "OT"  # every column is read, as in the JAX package
        get_dataset(cfg, "test")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        get_trainer("x", _cfg(Path("/nonexistent"), 8, "float32"), device="cuda")
