"""The port's pretraining task against the JAX package's, on the CPU:

  (a) the mixture: ``PretrainingDataset`` over the ECG, ventilator, bidmc
      and ludb stand-ins equal to JAX's (its length, each member's
      permutation, the tiled features, every item's keys and values) for
      each split and ``n_features`` "auto" / 2 / 5, and the batches of both
      pipelines (``dataset`` and ``dataset_description`` host lists);
  (b) the prompt: each row's ``Dataset: <its member's description>``, the
      ``prompt_ids`` equal to JAX's builder and no ``prefix_ids`` (no head
      is cached), on llama-tiny and mamba-tiny;
  (c) ``val()`` / ``test()`` in f32 on ``from_flax`` weights within 1e-5 of
      JAX's ``PretrainingTask``, the mixed eval within 2^-6, and three SGD
      steps under mixed at the bounds of tests/test_torch_mixed.py (loss
      2^-7, each tensor 2^-5 of its move, mapping_layer.bias 2^-4), on
      llama-tiny and mamba-tiny.

Sizes: two layers, history 32, batch 4, the mixture downsampled to 0.3 %
(47 train windows)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu.tasks.pretraining import PretrainingTask as JaxPretrainingTask
from medtsllm_tpu_torch.data import BatchPipeline
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.tasks.pretraining import PRETRAIN_DATASETS, PretrainingTask
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)


def _cfg(llm="llama-tiny", dtype="float32", n_features="auto", pct=0.003):
    cfg = make_config(task="pretraining", model="medtsllm", hist=32, pred=32, step=16,
                      loss="mse")
    cfg["tasks"]["pretraining"] = {"downsample_pct": pct, "n_features": n_features}
    cfg.training.batch_size = 4
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0,
                      "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": llm, "llm_layers": 2, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": False}}}
    return cfg


def _mixtures(cls, cfg):
    task = object.__new__(cls)
    task.config = cfg
    task.build_datasets()
    return task


# --------------------------------------------------------------------------
# (a) the mixture
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_features", ["auto", 2, 5])
def test_mixture_matches_jax(n_features):
    cfg = _cfg(n_features=n_features, pct=0.002)
    jt, tt = _mixtures(JaxPretrainingTask, cfg), _mixtures(PretrainingTask, cfg)
    want_c = 3 if n_features == "auto" else n_features
    for split in ("train", "val", "test"):
        jd, td = getattr(jt, f"{split}_dataset"), getattr(tt, f"{split}_dataset")
        assert td.dataset_names == jd.dataset_names == PRETRAIN_DATASETS
        assert len(td) == len(jd) > 0 and td.lens == jd.lens
        for a, b in zip(td.dataset_inds, jd.dataset_inds):
            assert np.array_equal(a, b)
        assert (td.n_features, td.real_features, td.n_points, td.step_size, td.n_classes) == (
            jd.n_features, jd.real_features, jd.n_points, jd.step_size, jd.n_classes)
        assert td.n_features == want_c and not td.univariate and not td.clip_dataset
        idx = np.arange(len(jd))
        assert np.array_equal(td.x_starts(idx), jd.x_starts(idx))
        for i in idx:
            got, want = td[int(i)], jd[int(i)]
            assert set(got) == set(want) == {"x_enc", "dataset", "dataset_description"}
            assert got["x_enc"].dtype == want["x_enc"].dtype
            assert np.array_equal(got["x_enc"], want["x_enc"]) and got["x_enc"].shape[1] == want_c
            assert (got["dataset"], got["dataset_description"]) == (
                want["dataset"], want["dataset_description"])
        n = 0
        for jb, tb in zip(JaxBatchPipeline(jd, 4), BatchPipeline(td, 4)):
            assert set(jb) == set(tb)
            for k in ("dataset", "dataset_description"):
                assert isinstance(tb[k], list) and tb[k] == jb[k]
            for k in ("x_enc", "index", "valid"):
                assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k
            n += 1
        assert n == len(BatchPipeline(td, 4))


def test_mixture_tiles_narrow_members():
    """A one-feature member (ludb) is tiled across the width; a wider
    width than any member cycles the features."""
    tt = _mixtures(PretrainingTask, _cfg(n_features=5, pct=0.002))
    ds = tt.test_dataset
    for i in range(len(ds)):
        item = ds[i]
        x = item["x_enc"]
        if item["dataset"] == "ludb":
            assert (x == x[:, :1]).all()
        if item["dataset"] == "bidmc":
            assert np.array_equal(x[:, 3:], x[:, :2])


# --------------------------------------------------------------------------
# (b) the prompt, (c) the trainer
# --------------------------------------------------------------------------

@functools.cache
def _pair(llm, dtype):
    cfg = _cfg(llm, dtype)
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


@pytest.mark.parametrize("llm", ["llama-tiny", "mamba-tiny"])
def test_prompt_ids_match_jax(llm):
    jt, tt = _pair(llm, "float32")
    descriptions = set()
    for split in ("train", "test"):
        for jb, tb in zip(JaxBatchPipeline(getattr(jt, f"{split}_dataset"), 4),
                          BatchPipeline(getattr(tt, f"{split}_dataset"), 4)):
            pre, _ = tt.preprocessor.build_prompts(tb)
            assert [p[1] for p in pre] == [f"Dataset: {d} " for d in tb["dataset_description"]]
            descriptions.update(tb["dataset_description"])
            got, want = tt.model_inputs(tb), jt.model_inputs(jb)
            assert "prefix_ids" not in got and "prefix_ids" not in want
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert len(descriptions) == 4  # every member's prompt
    assert not tt._prefix_kv_store  # nothing was prefilled


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("llm", ["llama-tiny", "mamba-tiny"])
def test_pretraining_f32_matches_jax(llm):
    jt, tt = _pair(llm, "float32")
    for pj, pt in ((jt.val_pipeline, tt.val_pipeline), (jt.test_pipeline, tt.test_pipeline)):
        oj, ot = jt.run_eval(pj, extra_keys=("index",)), tt.run_eval(pt, extra_keys=("index",))
        assert ot["pred"].shape == oj["pred"].shape == (len(pt.dataset), 32, 3)
        assert np.array_equal(ot["index"], oj["index"])
        _close(ot["pred"], oj["pred"])
        (pj_, tj), (pt_, tt_) = jt.predict(pj), tt.predict(pt)
        _close(pt_, pj_)
        _close(tt_, tj)
    for fn in ("val", "test"):
        sj, st = getattr(jt, fn)(), getattr(tt, fn)()
        assert set(st) == set(sj)
        for k, v in sj.items():
            _close(st[k], v)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _three_sgd_steps(jt, shared):
    """Three SGD steps on the same shuffled batches from the same weights,
    the whole prompt embedded in the step on both sides -> (each step's
    relative loss gap, {trainable tensor: (|port - JAX|, JAX's move)}); the
    backbone unchanged."""
    tt = get_trainer("port-train", shared.config, device="cpu")  # fresh optimizer state
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jpipe = JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)
    tpipe = BatchPipeline(tt.train_dataset, 4, shuffle=True, seed=0)
    loss_gaps = []
    for step, (jb, tb) in enumerate(zip(jpipe, tpipe)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert "prefix_kv" not in ja and "prefix_kv" not in ta and "prefix_ids" not in ta
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        loss_gaps.append(abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)))
    want = from_flax(jax.device_get(params))
    got = tt.model.state_dict()
    gaps = {}
    for k in got:
        if k.startswith("llm."):
            assert torch.equal(got[k], start[k]), k
            continue
        gaps[k] = (np.abs(_np(got[k]) - _np(want[k])).max(),
                   np.abs(_np(want[k]) - _np(start[k])).max(),
                   np.abs(_np(got[k]) - _np(start[k])).max())
    largest = max(move for _, move, _ in gaps.values())
    for k, (_, move, port_move) in list(gaps.items()):
        if k.endswith("key_projection.bias"):
            # softmax over the keys cancels this bias: neither side moves it
            assert max(move, port_move) <= 1e-3 * largest, k
            del gaps[k]
        else:
            assert move > 0, k
    return loss_gaps, {k: err / move for k, (err, move, _) in gaps.items()}


@pytest.mark.parametrize("llm", ["llama-tiny", "mamba-tiny"])
def test_pretraining_sgd_steps_match_jax(llm):
    """f32: three SGD steps within 1e-5 (loss) and 1e-3 of each tensor's
    move (summation order only), so the mixed gaps below are rounding,
    not a different gradient. Mixed: the eval within 2^-6 x max; three
    steps' losses within 2^-7 and each tensor within 2^-5 of its move
    (mapping_layer.bias 2^-4) on llama-tiny, as tests/test_torch_mixed.py
    holds the tasks; on mamba-tiny within 2^-4 (mapping_layer.bias 2^-3):
    XLA and torch round the bf16 scan's products and sums in their own
    orders through the recurrence, and the gap measured here is 0.052 of
    output_projection.weight's move (0.031 the largest on llama-tiny)."""
    loss_gaps, ratios = _three_sgd_steps(*_pair(llm, "float32"))
    assert max(loss_gaps) <= 1e-5 and max(ratios.values()) <= 1e-3, (loss_gaps, ratios)
    jt, tt = _pair(llm, "mixed")
    for pj, pt in ((jt.val_pipeline, tt.val_pipeline), (jt.test_pipeline, tt.test_pipeline)):
        want, got = jt.run_eval(pj)["pred"], tt.run_eval(pt)["pred"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    loss_gaps, ratios = _three_sgd_steps(jt, tt)
    assert max(loss_gaps) <= 2.0 ** -7, loss_gaps
    tol = 2.0 ** -5 if llm == "llama-tiny" else 2.0 ** -4
    for k, ratio in ratios.items():
        assert ratio <= (2 * tol if k == "mapping_layer.bias" else tol), (k, ratio)


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
def test_pretraining_train_val_test_run(dtype):
    tt = get_trainer("port", _cfg("llama-tiny", dtype), device="cpu")
    tt.train()
    assert len(tt.losses) == len(tt.train_pipeline) and np.isfinite(tt.losses).all()
    assert len(tt.val_scores) == 1 and np.isfinite(tt.best_score)
    scores = tt.test()
    assert set(scores) == {"test/mse", "test/mae"}
    assert all(np.isfinite(v) for v in scores.values())
