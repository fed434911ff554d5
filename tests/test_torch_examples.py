"""In-context examples (``prompting.examples``) in the port against the JAX
package, on the CPU: configs/ablation/ecgmit-seg-examples.toml's prompt
layout (segmentation on the ECG family's stand-in, 2 features, dataset,
clip and task prompts) cut to llama-tiny (2 layers), history 128, patch 8
/ 4, batch 4, an example pool of 16 segments (median 112 points):

  (a) the prompt builder: ``prefix_ids`` (the 1-D head [bos + dataset]:
      neither the task nor the clip joins it under examples),
      ``prompt_ids`` (the first part, ending in the example's text),
      ``example_ts`` and ``post_prompt_ids`` (a grow-only 16-granular
      bucket) equal to JAX's on the test batches;
  (b) ``example_len`` from the dataset's pool (min(history, max(patch,
      median))), not from a batch: the same under another batch size and
      after other batches; without a pool, from the model's sizes alone;
      each example cropped or tiled to it;
  (c) the f32 eval step within 1e-5 of JAX's ``eval_step``, the
      reprogramming attention (K3) run twice a step, at the window's 32
      patches and the example's 28;
  (d) the cached head [bos + dataset] against the head embedded in the
      step (1e-5);
  (e) three SGD train steps against JAX's ``train_step`` (the head from
      the train cache on both sides) at tests/test_torch_train.py's dense
      f32 bounds;
  (f) under ``mixed`` (the shipped file's dtype), the eval step within
      2^-6 of the largest of JAX's mixed trainer's
      (tests/test_torch_mixed.py's bound);
  (g) the per-channel covariate modes with examples raise in both
      packages (JAX asserts at its init).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.models import medtsllm as tmodel
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

ARRAYS = ("prefix_ids", "prompt_ids", "example_ts", "post_prompt_ids", "x_enc")


def _cfg(covariate_mode="concat", batch=4, dtype="float32"):
    cfg = make_config(task="segmentation", model="medtsllm", hist=128, pred=128, step=128,
                      loss="bce", eval_metric="segment_miou", eval_dir="max", dataset="ECG")
    cfg.training.batch_size = batch
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    cfg.setup.dtype = dtype
    cfg["datasets"] = {"ECG": {"version": "v2"}}
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": covariate_mode, "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": True, "input_stats": False,
                      "examples": True, "example_pool": 16, "input_stats_dim": "all",
                      "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": False}}}
    return cfg


@functools.cache
def _pair(dtype="float32"):
    cfg = _cfg(dtype=dtype)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return cfg, jt, tt


def _batches(jt, tt, n=3):
    return list(zip(jt.test_pipeline, tt.test_pipeline))[:n]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def test_prompt_arrays_match_jax():
    """(a)"""
    _, jt, tt = _pair()
    assert tt.train_dataset.n_examples == 16
    for jb, tb in _batches(jt, tt):
        assert "examples" in tb
        ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
        assert set(ja) == set(ta) and set(ARRAYS) <= set(ta)
        for k in ARRAYS:
            assert np.array_equal(np.asarray(ja[k]), np.asarray(ta[k])), k
        assert ta["prefix_ids"].ndim == 1 and ta["example_ts"].dtype == np.float32
        assert ta["example_ts"].shape == (4, 112, 2)
        assert ta["post_prompt_ids"].shape[1] % 16 == 0
        head = tt.preprocessor._encode(tt.preprocessor.bos) + tt.preprocessor._encode(
            f"Dataset: {tt.preprocessor.dataset_description} ")
        assert list(ta["prefix_ids"]) == head
        text = tt.preprocessor._encode("Example segment: ")
        assert list(ta["prompt_ids"][0][-len(text):]) == text
    pb, jpb = tt.preprocessor, jt.preprocessor
    assert (pb.max_bucket_suffix, pb.max_bucket_post) == (jpb.max_bucket_suffix,
                                                          jpb.max_bucket_post)


def test_example_len_from_the_pool():
    """(b)"""
    cfg, jt, tt = _pair()
    med = int(np.median([len(e) for e in tt.train_dataset.examples]))
    assert med == 112 and tt.preprocessor.example_len == jt.preprocessor.example_len == 112
    other = get_trainer("port-b8", _cfg(batch=8), device="cpu")
    for batch in other.train_pipeline:
        other.model_inputs(batch)
    assert other.preprocessor.example_len == 112
    pb = tt.preprocessor
    long_seg, short_seg = np.full((130, 2), 7.0, np.float32), np.arange(6.0).reshape(3, 2)
    out = pb._example_tensor({"examples": [("x", long_seg[None]), ("x", short_seg[None])]})
    assert np.array_equal(out[0], long_seg[:112])
    assert np.array_equal(out[1], np.tile(short_seg, (38, 1))[:112])
    # no pool at __init__: the model's sizes alone (history / 4)
    bare = tmodel.PromptBuilder(cfg, type("D", (), {"description": "d"})(), tt.model)
    assert not hasattr(bare, "example_len")
    # the post bucket: 16-granular, grow-only (JAX's test_examples_prompting)
    assert [bare._bucket_post(n) for n in (18, 2, 49)] == [32, 32, 64]
    assert bare._example_tensor({"examples": [("x", long_seg[None])]}).shape == (1, 32, 2)


def test_eval_matches_jax(monkeypatch):
    """(c)"""
    _, jt, tt = _pair()
    calls = []
    k3 = tmodel.reprogramming_attention
    monkeypatch.setattr(tmodel, "reprogramming_attention",
                        lambda q, *a: calls.append(tuple(q.shape)) or k3(q, *a))
    for jb, tb in _batches(jt, tt):
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).numpy()
        assert got.shape == want.shape == (4, 128)
        _close(got, want)
    assert calls[:2] == [(4, 32, 4, 16), (4, 28, 4, 16)]


def test_cached_head_equals_embedded():
    """(d)"""
    _, jt, tt = _pair()
    for _, tb in _batches(jt, tt, 2):
        cached = tt.eval_model_inputs(tb)
        assert "prefix_kv" in cached and "prefix_ids" not in cached
        assert "example_ts" in cached and "post_prompt_ids" in cached
        embedded = tt._to_device(tt.model_inputs(tb))
        _close(tt.eval_step(cached).numpy(), tt.eval_step(embedded).numpy())


def test_train_steps_match_jax():
    """(e)"""
    cfg, jt, _ = _pair()
    tt = get_trainer("port-train", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert "prefix_kv" in ja and "prefix_kv" in ta and "example_ts" in ta
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        want = from_flax(jax.device_get(params))
        for k, v in tt.model.state_dict().items():
            if not k.startswith("llm."):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {step}: {k}")


def test_mixed_eval_matches_jax():
    """(f)"""
    _, jt, tt = _pair("mixed")
    for jb, tb in _batches(jt, tt, 2):
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["independent", "merge-end"])
def test_per_channel_modes_refuse_examples(mode):
    """(g)"""
    cfg = _cfg(mode)
    with pytest.raises(AssertionError, match="batch-preserving"):
        jax_get_trainer("jax", cfg)
    with pytest.raises(ValueError, match="batch-preserving"):
        get_trainer("port", cfg, device="cpu")
    _, _, tt = _pair()
    arrays = tt._to_device(tt.model_inputs(next(iter(tt.test_pipeline))))
    tt.model.covariate_mode = mode
    try:
        with pytest.raises(ValueError, match="batch-preserving"):
            tt.eval_step(arrays)
    finally:
        tt.model.covariate_mode = "concat"
