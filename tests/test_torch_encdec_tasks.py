"""MedTsLLM over the encoder-decoder backbones (t5, bart and the llama-style
``encdec-tiny``) through the trainers, the port against the JAX package on
the CPU.

  (a) ``eval_dispatch`` against JAX's ``eval_step`` on every test batch
      under ``concat`` and ``independent`` (dense 1e-5, w8a8 2e-3 of the
      largest: the flip-sized bound of ROADMAP queue 3), ``test()``'s
      scores, no prefix cache and no ``prefix_ids`` for any encoder-decoder
      (``encdec-tiny`` has llama's style); the refusal without a prompt;
  (b) three SGD train steps against JAX's ``train_step`` (t5 dense, bart
      with LoRA; test_torch_train.py's bounds: loss rtol 1e-5, each tensor
      rtol 1e-4, atol 1e-5), the frozen backbone unmoved, the adapters
      moved.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax
from test_torch_families import jitted_flax_init

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# --------------------------------------------------------------------------
# (a) MedTsLLM through the trainers
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm, quant=False, mode="concat", lora=False, prompting=True):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    cfg.datasets.synthetic.n_points = 200
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": mode, "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": prompting, "task": prompting, "clip": False,
                      "input_stats": prompting, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": quant}}}
    if lora:
        cfg.models.medtsllm["lora"] = {"enabled": True, "rank": 4, "alpha": 8,
                                       "dropout": 0.0, "layers": "auto"}
    return cfg


def _pair(cfg):
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


_SERVED = [("t5-tiny", False, "concat"), ("bart-tiny", False, "independent"),
           ("encdec-tiny", True, "concat")]


@pytest.mark.parametrize("llm,quant,mode", _SERVED,
                         ids=[f"{n}-{'w8a8' if q else 'dense'}-{m}" for n, q, m in _SERVED])
def test_medtsllm_eval_matches_jax(tmp_path, llm, quant, mode):
    jt, tt = _pair(_cfg(tmp_path, llm, quant, mode))
    assert tt.model.llm_cfg.is_encoder_decoder and isinstance(tt.model.llm,
                                                              ttf.TransformerEncDec)
    assert not tt.model.supports_prefix_cache and not jt.model.supports_prefix_cache
    assert not tt.preprocessor.split_prefix
    tol = 2e-3 if quant else 1e-5
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
        assert "prefix_ids" not in ta and set(ja) == set(ta)
        np.testing.assert_array_equal(ja["prompt_ids"], ta["prompt_ids"])
        prepared = tt.eval_prepare(tb)
        assert "prefix_kv" not in prepared[1]
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    want, got = jt.test(), tt.test()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol)


def test_medtsllm_needs_a_prompt(tmp_path):
    """JAX asserts a prompt for an encoder-decoder; the port raises."""
    tt = get_trainer("port", _cfg(tmp_path, "t5-tiny", prompting=False), device="cpu")
    batch = next(iter(tt.test_pipeline))
    with pytest.raises(ValueError, match="require prompting"):
        tt.eval_step(tt._to_device(tt.model_inputs(batch)))


# --------------------------------------------------------------------------
# (b) training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("llm,lora", [("t5-tiny", False), ("bart-tiny", True)])
def test_train_steps_match_jax_trainer(tmp_path, llm, lora):
    """Three SGD steps on the same shuffled batches: each loss (rtol 1e-5)
    and every trainable tensor after it (rtol 1e-4, atol 1e-5); the frozen
    backbone (but the adapters) unmoved, the adapters moved."""
    cfg = _cfg(tmp_path, llm, lora=lora)
    jt, tt = _pair(cfg)
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    adapters = {n for n in trainable if n.startswith("llm.")}
    assert bool(adapters) == lora and all("lora_" in n for n in adapters)
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    frozen = {k: v.clone() for k, v in tt.model.state_dict().items()
              if k.startswith("llm.") and k not in adapters}
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert "prefix_kv" not in ta
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        for k in trainable:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {step}: {k}")
    got = tt.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in frozen.items())
    assert all(not torch.equal(got[k], torch.zeros_like(got[k])) for k in adapters
               if k.endswith("lora_b"))
