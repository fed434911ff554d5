"""Clip datasets, per-clip prompt heads, the per-clip KV bank and the banked
eval step of the port against the JAX package, on the CPU (llama-tiny, 2
layers, history 32; configs cut from ecgmit-seg.toml, ventilator.toml and
ludb.toml: 6 or 5 clips of ~66-80 points, batch 4, 2 bank slots asked):

  (a) the clip synthetic data: windows, ``clip_ids``, descriptions,
      ``mask`` and the batches (descriptions as host lists) bit-equal to
      JAX's ``get_dataset``;
  (b) the prompt builder: the [B, P] per-clip head rows, the remainder's
      ids and both buckets equal to JAX's on every batch; a 1-D head where
      ``prompting.clip`` is off (ludb);
  (c) the bank's bookkeeping (slots, the row of each slot, the tick of
      each slot's last use, the capacity) equal to JAX's
      ``_clip_bank_lookup`` over a stream with more rows than slots, rows
      repeated within a batch and batches wider than the bank (growth);
      the bank's rows within 1e-5 of JAX's (f32);
  (d) ``run_eval`` through the banked step within 1e-5 of JAX's
      ``eval_dispatch`` (f32, ``weights.from_flax``) and of the port's own
      step with the head embedded; ``test()`` / ``val()`` scores within
      ``tests/test_torch_tasks.py``'s bounds;
  (e) the bank's tensors at the same addresses after a second pass and
      after ``load_state_dict``, ``step_key`` with them; a wider batch grows
      the bank (new tensors, a new key);
  (f) three SGD train steps on the clip dataset, the per-clip head embedded
      in the graph on both sides, against JAX's ``train_step``: f32 at
      ``tests/test_torch_train.py``'s tolerances; mixed: the losses within
      ``tests/test_torch_mixed.py``'s 2^-7, each tensor within 2^-4 of its
      move (that file holds 2^-5: on this data the reprogramming key and
      query weights sit at 0.035 / 0.032 of their moves, already after the
      first step) and mapping_layer.bias within 2^-3 (0.087 here: its
      gradient cancels to 0.050 of its terms, shown as that file's (f)
      shows it);
  (g) ``covariate_mode = "univariate"`` with more than one feature raises,
      the other known modes build and serve through the banked step, an
      unknown one is a ValueError; the in-context examples without an
      example pool change nothing; on a Mamba backbone the clip stays in
      the computed remainder (its state cache keeps one entry).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.data import get_dataset as jax_get_dataset
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.data import BatchPipeline, SyntheticDataset
from medtsllm_tpu_torch.runtime.graph import step_key
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

# kind -> (task, loss, eval metric and direction, overrides); the prompting
# of each shipped config
KINDS = {
    "ecgmit-seg": ("segmentation", "bce", ("segment_miou", "max"),
                   {"datasets.synthetic.n_clips": 6}, {"clip": True, "input_stats": False}),
    "ventilator": ("semantic_segmentation", "bce", ("iou", "max"),
                   {"datasets.synthetic.n_clips": 5}, {"clip": True, "input_stats": True}),
    "ludb": ("semantic_segmentation", "ce", ("iou", "max"),
             {"datasets.synthetic.n_clips": 5, "datasets.synthetic.n_classes": 4,
              "datasets.synthetic.n_features": 1}, {"clip": False, "input_stats": False}),
}


def _cfg(kind, dtype="float32"):
    task, loss, (metric, direction), over, prompting = KINDS[kind]
    cfg = make_config(task=task, model="medtsllm", hist=32, pred=32, step=16, loss=loss,
                      eval_metric=metric, eval_dir=direction,
                      **{"datasets.synthetic.clips": True, **over})
    cfg.datasets.synthetic.n_points = 400
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "univariate" if kind == "ludb" else "concat",
        "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "clip_cache_slots": 2, **prompting},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2,
                "prefix_cache": True, "load_in_4bit": False, "load_in_8bit": False}}}
    return cfg


@functools.cache
def _pair(kind, dtype="float32"):
    cfg = _cfg(kind, dtype)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


# --------------------------------------------------------------------------
# (a) the data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_clip_data_matches_jax(kind, split):
    cfg = _cfg(kind)
    jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
    assert jd.clip_dataset and td.clip_dataset and len(td) == len(jd) > 0
    assert np.array_equal(td.data, jd.data) and np.array_equal(td.labels, jd.labels)
    assert td.clip_ids.dtype == jd.clip_ids.dtype == np.int32
    assert np.array_equal(td.clip_ids, jd.clip_ids)
    assert td.clip_descriptions == jd.clip_descriptions
    assert td.mask.dtype == bool and np.array_equal(td.mask, jd.mask)
    idx = np.arange(len(jd))
    assert np.array_equal(td.x_starts(idx), jd.x_starts(idx))
    assert all(td[i]["descriptions"] == jd[i]["descriptions"] for i in idx)
    n = 0
    for jb, tb in zip(JaxBatchPipeline(jd, 4), BatchPipeline(td, 4)):
        assert set(jb) == set(tb)
        assert isinstance(tb["descriptions"], list) and tb["descriptions"] == jb["descriptions"]
        for k in set(jb) - {"descriptions"}:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k
        n += 1
    assert n == len(BatchPipeline(td, 4)) > 1


def test_clip_windows_stay_inside_their_clip():
    td = SyntheticDataset(_cfg("ventilator"), "test")
    starts = td.x_starts(np.arange(len(td)))
    ids = td.clip_ids
    assert (ids[starts] == ids[starts + td.pred_len - 1]).all()
    assert not td.mask.all() and td.mask.any()  # each clip's remainder is left out


# --------------------------------------------------------------------------
# (b) the prompt builder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prompt_builder_matches_jax(kind):
    jt, tt = _pair(kind)
    assert tt.preprocessor.clip_in_head({"descriptions": []}) == (kind != "ludb")
    for jpipe, tpipe in ((jt.train_pipeline, tt.train_pipeline),
                         (jt.val_pipeline, tt.val_pipeline),
                         (jt.test_pipeline, tt.test_pipeline)):
        for jb, tb in zip(JaxBatchPipeline(jpipe.dataset, 4), BatchPipeline(tpipe.dataset, 4)):
            ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
            assert set(ja) == set(ta)
            for k in ("prefix_ids", "prompt_ids"):
                assert np.asarray(ja[k]).shape == ta[k].shape, k
                assert np.array_equal(np.asarray(ja[k]), ta[k]), k
            assert ta["prefix_ids"].ndim == (1 if kind == "ludb" else 2)
    jp, tp = jt.preprocessor, tt.preprocessor
    assert tp.max_bucket_suffix == jp.max_bucket_suffix
    assert tp.max_bucket_head == getattr(jp, "max_bucket_head", 16)
    if kind != "ludb":  # the head rows are left-padded: a row's last token is real
        rows = tt.model_inputs(next(iter(tt.test_pipeline)))["prefix_ids"]
        assert (rows[:, -1] != tp.pad_id).all() and rows.shape[1] % 16 == 0


# --------------------------------------------------------------------------
# (c) the bank's bookkeeping
# --------------------------------------------------------------------------

def test_bank_bookkeeping_matches_jax():
    jt, tt = _pair("ecgmit-seg")
    rows = np.random.default_rng(0).integers(1, 500, size=(9, 16)).astype(np.int64)
    stream = [[0, 1], [1, 2], [3, 0, 3, 4], [5, 6, 0, 1, 2], [2, 7], [8, 8, 3],
              [4, 5, 6, 7, 8, 0], [1]]
    jt._prefix_kv_cache.clear()
    tt._prefix_kv_cache.clear()
    evictions = 0
    for picks in stream:
        ids = rows[picks]
        _, slots_j = jt._clip_bank_lookup(ids.astype(np.int32), False, False)
        bank, slots_t = tt._clip_bank_lookup(ids)
        assert slots_t == np.asarray(slots_j).tolist(), picks
        bj = jt._prefix_kv_cache[("clip_bank", 16, False)]
        bt = tt._prefix_kv_cache[("clip_bank", 16, False)]
        for k in ("last_use", "tick", "cap"):
            assert bt[k] == bj[k], k
        assert ({s: np.frombuffer(r, np.int64).tolist() for s, r in bt["row_of"].items()}
                == {s: np.frombuffer(r, np.int32).tolist() for s, r in bj["row_of"].items()})
        assert bank[0][0].shape[0] == bt["cap"] == bj["kv"][0][0].shape[0]
        for layer_t, layer_j in zip(bank, bj["kv"]):
            for t, j in zip(layer_t, layer_j):
                _close(_np(t), _np(j))
        evictions = bt["evictions"]
    assert evictions > 0 and bt["cap"] == 6 and bt["misses"] == evictions + len(bt["slot_of"])


# --------------------------------------------------------------------------
# (d) the banked eval step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eval_matches_jax(kind):
    """run_eval's window outputs (banked for the per-clip heads), the
    stitched predictions and the val / test scores."""
    jt, tt = _pair(kind)
    for pj, pt in ((jt.val_pipeline, tt.val_pipeline), (jt.test_pipeline, tt.test_pipeline)):
        oj = jt.run_eval(pj, extra_keys=("index",))
        ot = tt.run_eval(pt, extra_keys=("index",))
        assert np.array_equal(ot["index"], oj["index"])
        assert ot["pred"].shape == oj["pred"].shape
        _close(ot["pred"], oj["pred"])
        if kind == "ecgmit-seg":
            rj, rt = jt.predict(pj), tt.predict(pt)
            assert len(rt["preds_raw"]) == pt.dataset.mask.sum()
            _close(rt["preds_raw"], rj["preds_raw"])
            assert np.array_equal(rt["pred_points"], rj["pred_points"])
        else:
            (pred_j, lab_j), (pred_t, lab_t) = jt.predict(pj), tt.predict(pt)
            assert len(lab_t) == pt.dataset.mask.sum() and np.array_equal(lab_t, lab_j)
            _close(pred_t, pred_j)
    if kind != "ludb":
        (key, book), = [(k, v) for k, v in tt._prefix_kv_cache.items() if k[0] == "clip_bank"]
        assert book["evictions"] > 0  # more clips than the bank's rows
    for fn in ("val", "test"):
        sj, st = getattr(jt, fn)(), getattr(tt, fn)()
        assert set(st) == set(sj)
        for k, v in sj.items():
            _close(st[k], v)


def test_banked_step_equals_embedded_head():
    """Each test batch through the banked step against the same batch with
    its [B, P] head embedded in the graph (no cache)."""
    _, tt = _pair("ventilator")
    tt._prefix_kv_cache.clear()
    n = 0
    for batch in tt.test_pipeline:
        kind, arrays = tt.eval_prepare(batch)
        assert kind == "banked" and arrays["prefix_slots"].shape == (4,)
        assert "prefix_kv" not in arrays and len(arrays["prefix_bank"]) == 2
        banked = tt.eval_step(arrays)
        inputs = tt._to_device(tt.model_inputs(batch))
        assert inputs["prefix_ids"].dim() == 2
        embedded = tt.eval_step_eager(inputs)
        _close(banked.numpy(), embedded.numpy())
        n += 1
    assert n > 1


def test_bank_kept_across_passes_and_weights():
    _, tt = _pair("ecgmit-seg")
    batch = next(iter(tt.test_pipeline))
    tt.run_eval(tt.test_pipeline)
    key = ("clip_bank", tt.model_inputs(batch)["prefix_ids"].shape[1], False)
    bank = tt._prefix_kv_store[key]
    ptrs = [t.data_ptr() for layer in bank for t in layer]
    first = tt.run_eval(tt.test_pipeline)["pred"]
    _, arrays = tt.eval_prepare(batch)
    sig = step_key(arrays)
    assert tt.run_eval(tt.test_pipeline)["pred"].tobytes() == first.tobytes()
    assert step_key(tt.eval_prepare(batch)[1]) == sig
    saved = {k: v.clone() for k, v in tt.model.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    tt.load_state_dict({k: v + 0.05 * v.abs().amax() * torch.randn(v.shape, generator=g)
                        if v.is_floating_point() else v for k, v in saved.items()})
    moved = tt.run_eval(tt.test_pipeline)["pred"]
    assert not np.allclose(moved, first)
    assert tt._prefix_kv_store[key] is bank
    assert [t.data_ptr() for layer in bank for t in layer] == ptrs
    assert step_key(tt.eval_prepare(batch)[1]) == sig
    tt.load_state_dict(saved)
    assert tt.run_eval(tt.test_pipeline)["pred"].tobytes() == first.tobytes()
    # a batch wider than the bank grows it: new tensors, a new signature
    ids = tt.model_inputs(batch)["prefix_ids"]
    cap = tt._prefix_kv_cache[key]["cap"]
    tt._clip_bank_lookup(np.concatenate([ids] * (cap // len(ids) + 1)))
    assert tt._prefix_kv_store[key] is not bank
    assert tt._prefix_kv_store[key][0][0].shape[0] > cap
    assert step_key(tt.eval_prepare(batch)[1]) != sig
    tt._prefix_kv_cache.clear()


# --------------------------------------------------------------------------
# (f) training on a clip dataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "mixed"])
def test_train_steps_match_jax(dtype):
    """Three SGD steps on the same shuffled clip batches; the per-clip head
    is embedded in the graph on both sides (never served from the bank)."""
    cfg = _cfg("ecgmit-seg", dtype)
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jpipe = JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert "prefix_kv" not in ta and ta["prefix_ids"].dim() == 2
        assert np.array_equal(np.asarray(ja["prefix_ids"]), ta["prefix_ids"].numpy())
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=rtol)
        if dtype == "float32":  # tests/test_torch_train.py's bounds, step by step
            want, got = from_flax(jax.device_get(params)), tt.model.state_dict()
            for k in got:
                if not k.startswith("llm."):
                    np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4,
                                               atol=1e-5, err_msg=f"step {step}: {k}")
    assert not any(k[0] == "clip_bank" for k in tt._prefix_kv_cache)
    got = tt.model.state_dict()
    for k in got:
        if k.startswith("llm."):
            assert torch.equal(got[k], start[k]), k
    if dtype == "mixed":  # tests/test_torch_mixed.py's bounds on each tensor's move
        want = from_flax(jax.device_get(params))
        moves = {k: np.abs(_np(want[k]) - _np(start[k])).max() for k in got
                 if not k.startswith("llm.")}
        largest = max(moves.values())
        for k, move in moves.items():
            err = np.abs(_np(got[k]) - _np(want[k])).max()
            if k.endswith("key_projection.bias"):  # exact gradient 0: rounding only
                port_move = np.abs(_np(got[k]) - _np(start[k])).max()
                assert max(move, port_move) <= 1e-3 * largest, k
                continue
            # measured: mapping_layer.bias 0.087 of its move, as its gradient
            # cancels to 0.050 of its terms (test_mapping_bias_gap_on_clips);
            # the reprogramming key / query weights 0.035 / 0.032, every other
            # leaf under 0.025
            tol = 2.0 ** -3 if k == "mapping_layer.bias" else 2.0 ** -4
            assert move > 0 and err <= tol * move, (k, err, move)


def test_mapping_bias_gap_on_clips():
    """Why mapping_layer.bias moves farthest from JAX's in the mixed steps
    above, as tests/test_torch_mixed.py (f) shows on its data: in the first
    step the cotangents of the mapping layer's output agree within 2^-5 of
    the largest, each package's bias gradient is exactly its own sum of its
    cotangent (JAX's as XLA's CPU backend sums bf16, the port's at f32,
    rounded once), and that sum cancels to 0.050 of its terms' magnitudes
    on this clip data (within 2^-3 there), magnifying both differences."""
    import flax.linen as fnn

    from test_torch_mixed import _xla_cpu_bf16_sum
    cfg = _cfg("ecgmit-seg", "mixed")
    cfg.training.optimizer = "sgd"
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    jb = next(iter(JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)))
    tb = next(iter(tt.train_pipeline))
    ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
    ml = tt.model.mapping_layer

    def loss_j(params, delta):  # JAX's train-step loss, delta added to the mapping output
        params = jax.tree.map(lambda x, l: jax.lax.stop_gradient(x) if l == "frozen" else x,
                              params, jt.param_label_tree)

        def add_delta(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            return out + delta.astype(out.dtype) if context.module.name == "mapping_layer" \
                else out
        with fnn.intercept_methods(add_delta):
            pred = jt.model.apply({"params": jt._cast_for_compute(params)},
                                  jt._cast_for_compute(ja), training=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jt.loss_fn(pred.astype(jnp.float32), ja, jnp.asarray(jb["valid"]))
    loss_jax, (grads, cot) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jt.params, jnp.zeros((tt.model.llm_cfg.d_model, ml.out_features), jnp.float32))
    cot_j, bias_j = _np(cot), _np(grads["mapping_layer"]["bias"])
    seen = []

    def keep_cotangent(module, args, out):
        out.register_hook(lambda g: seen.append(g.float().numpy().copy()))
    hook = ml.register_forward_hook(keep_cotangent)
    try:
        loss_t = tt.train_step(ta, ta["valid"])
    finally:
        hook.remove()
    cot_t, bias_t = seen[0], _np(ml.bias.grad)
    assert abs(float(loss_t) - float(loss_jax)) <= 2.0 ** -7 * abs(float(loss_jax))
    np.testing.assert_allclose(cot_t, cot_j, rtol=0, atol=2.0 ** -5 * np.abs(cot_j).max())
    assert np.array_equal(bias_j, _xla_cpu_bf16_sum(cot_j))
    assert np.array_equal(bias_t, _np(torch.from_numpy(cot_t.sum(0)).bfloat16()))
    assert np.abs(cot_j.sum(0)).max() <= 0.06 * np.abs(cot_j).sum(0).max()


# --------------------------------------------------------------------------
# (g) the covariate modes
# --------------------------------------------------------------------------

def test_covariate_modes():
    """The other known modes build and serve the clip dataset through the
    banked step (tests/test_torch_modes.py holds them against JAX);
    ``prompting.examples`` on a dataset without an example pool builds and
    serves as without it."""
    cfg = _cfg("ludb")
    cfg.datasets.synthetic.n_features = 3
    with pytest.raises(ValueError, match="univariate"):
        get_trainer("x", cfg, device="cpu")
    for mode in ("independent", "interleave", "add", "weighted-average", "merge-end"):
        cfg = _cfg("ecgmit-seg")
        cfg.models.medtsllm.covariate_mode = mode
        tt = get_trainer("x", cfg, device="cpu")
        batch = next(iter(tt.test_pipeline))
        assert tt.eval_prepare(batch)[0] == "banked"
        out = tt.eval_dispatch(batch)
        assert out.shape == (4, 32) and torch.isfinite(out).all(), mode
    cfg.models.medtsllm.covariate_mode = "sideways"
    with pytest.raises(ValueError, match="Unknown covariate_mode"):
        get_trainer("x", cfg, device="cpu")
    cfg = _cfg("ecgmit-seg")
    cfg.models.medtsllm.prompting.examples = True
    tt = get_trainer("x", cfg, device="cpu")
    batch = next(iter(tt.test_pipeline))
    assert "example_ts" not in tt.model_inputs(batch)
    assert torch.isfinite(tt.eval_dispatch(batch)).all()


def test_mamba_keeps_the_clip_in_the_remainder():
    """The Mamba state cache keeps one entry: on a clip dataset the head
    stays 1-D and the clip's description leads the computed remainder."""
    cfg = _cfg("ventilator")
    cfg.models.medtsllm.llm.llm = "mamba-tiny"
    tt = get_trainer("x", cfg, device="cpu")
    batch = next(iter(tt.test_pipeline))
    arrays = tt.model_inputs(batch)
    assert arrays["prefix_ids"].ndim == 1 and not tt.preprocessor.clip_in_head(batch)
    clip = tt.preprocessor._encode(batch["descriptions"][0] + " ")
    row = arrays["prompt_ids"][0].tolist()
    start = next(i for i, t in enumerate(row) if t != tt.preprocessor.pad_id)
    assert row[start:start + len(clip)] == clip
    scores = tt.test()
    assert scores and all(np.isfinite(v) for v in scores.values())
