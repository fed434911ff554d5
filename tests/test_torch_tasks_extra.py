"""The port's forecasting, classification and imputation tasks against the
JAX package, on the CPU:

  (a) the synthetic data: forecasting's ``x_enc`` / ``y`` windows and their
      counts on every split (step 16 and step 24 > pred_len 16),
      classification's window labels under ``majority``, ``last`` and
      ``any`` with 2 and 3 classes, and imputation's masks (two salts),
      bit-equal with JAX's ``get_dataset`` and ``ImputationTask._mask_for``;
  (b) ``masked_window_norm`` within 1e-6 of JAX's, a fully masked channel
      included;
  (c) the losses and their gradients against ``jax.grad`` within 1e-6,
      and the names both packages refuse;
  (d) each task's predict -> score chain on the same window predictions:
      equal to JAX's, forecasting's stitching (step > pred_len too)
      included; classification's scores within 1e-12 of the JAX task's
      sklearn scores;
  (e) each task end to end in f32 on ``from_flax`` weights: the eval step's
      window outputs within 1e-5 of JAX's, then the ``val()`` / ``test()``
      scores;
  (f) under ``mixed``: eval within 2^-6 of JAX's mixed trainer, and three
      SGD steps within tests/test_torch_mixed.py's bounds (2^-7 on the
      loss, 2^-5 of each tensor's move, 2^-4 on mapping_layer.bias), but
      for two gaps whose causes are shown exactly: classification's loss
      within 2^-5 and its tensors within 2^-4 of their moves (a
      cross-entropy over B rows of two bf16 logits averages no rounding
      away: the whole loss gap is the logits', and every gradient is a
      linear image of the logits' cotangent, which carries their gap;
      shown on the first step, and the steps after it compound it:
      measured 0.035 of the query projection's move), and forecasting's
      mapping_layer.bias within 2^-3 of its move (measured 0.069: the
      cancelling bf16 sum, shown for forecasting's first step as
      tests/test_torch_mixed.py shows it for segmentation);
  (g) ``train()``, ``val()`` and ``test()`` of each task under float32 and
      mixed; the mask feeding imputation's statistics; the captured step's
      key taking imputation's ``mask`` and ``y``; no ``NotImplementedError``
      in the port naming a ROADMAP item by number.

Sizes: llama-tiny, 2 layers, 300 synthetic points, history 32 (forecasting:
pred 16), batch 4.
"""

import ast
import functools
import re
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.data import get_dataset as jax_get_dataset
from medtsllm_tpu.ops.revin import masked_window_norm as jax_masked_window_norm
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu.tasks import losses as jlosses
from medtsllm_tpu_torch.data import BatchPipeline, SyntheticDataset
from medtsllm_tpu_torch.ops.revin import masked_window_norm
from medtsllm_tpu_torch.runtime.graph import step_key
from medtsllm_tpu_torch.tasks import get_trainer, losses
from medtsllm_tpu_torch.tasks.base import _cast
from medtsllm_tpu_torch.weights import from_flax
from test_torch_mixed import _xla_cpu_bf16_sum
from test_torch_tasks import _bare, _close, _equal, _hold_loss

torch.set_num_threads(1)

# case -> (task, loss, eval metric and direction, pred_len, overrides)
CASES = {
    "forecast": ("forecasting", "mse", ("mse", "min"), 16, {}),
    "classify": ("classification", "ce", ("f1", "max"), 32, {}),
    "impute": ("imputation", "mse", ("masked_mse", "min"), 32,
               {"tasks.imputation.mask_rate": 0.25}),
}


def _cfg(case, dtype="float32", **extra):
    task, loss, (metric, direction), pred, over = CASES[case]
    cfg = make_config(task=task, model="medtsllm", hist=32, pred=pred, step=16, loss=loss,
                      eval_metric=metric, eval_dir=direction, **{**over, **extra})
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 300
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0,
                      "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2,
                "prefix_cache": True, "load_in_4bit": False, "load_in_8bit": False}}}
    return cfg


def _hold_batches(jd, td):
    n = 0
    for jb, tb in zip(JaxBatchPipeline(jd, 4), BatchPipeline(td, 4)):
        assert set(jb) == set(tb)
        for k in jb:
            assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype, k
            assert np.array_equal(tb[k], jb[k]), k
        n += 1
    assert n == len(BatchPipeline(td, 4)) > 0


# --------------------------------------------------------------------------
# (a) the data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("step", [16, 24])
def test_forecast_data_matches_jax(step, split):
    cfg = _cfg("forecast", **{"data.step": step})
    jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
    step_size = 16 if split == "test" else step
    assert td.step_size == jd.step_size == step_size
    assert len(td) == len(jd) == (300 - 32 - 16 + 1) // step_size
    assert np.array_equal(td.data, jd.data) and td.labels is None and not td.clip_dataset
    idx = np.arange(len(jd))
    assert np.array_equal(td.x_starts(idx), jd.x_starts(idx))
    item = td[len(td) - 1]
    s = (len(td) - 1) * step_size
    assert np.array_equal(item["x_enc"], td.data[s:s + 32])
    assert np.array_equal(item["y"], td.data[s + 32:s + 48])
    _hold_batches(jd, td)


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("mode", ["majority", "last", "any"])
def test_classification_labels_match_jax(mode, n_classes):
    cfg = _cfg("classify", **{"tasks.classification.window_label": mode,
                              "datasets.synthetic.n_classes": n_classes})
    seen = set()
    for split in ("train", "val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        assert td.n_classes == jd.n_classes == (2 if mode == "any" else n_classes)
        assert td.labels.dtype == jd.labels.dtype and np.array_equal(td.labels, jd.labels)
        assert len(td) == len(jd)
        for i in range(len(td)):
            got, want = td[i]["labels"], jd[i]["labels"]
            assert type(got) is type(want) is np.int64 and got == want
            seen.add(int(got))
        _hold_batches(jd, td)
    assert seen == set(range(2 if mode == "any" else n_classes))


@pytest.mark.parametrize("salt", [0, 3])
def test_imputation_masks_match_jax(salt):
    from medtsllm_tpu.tasks.imputation import ImputationTask as JImp
    from medtsllm_tpu_torch.tasks.imputation import ImputationTask as TImp
    cfg = _cfg("impute")
    jt, tt = object.__new__(JImp), object.__new__(TImp)
    jt.config = tt.config = cfg
    idx = np.arange(37) * 3
    want, got = jt._mask_for(idx, (32, 3), salt=salt), tt.mask_for(idx, (32, 3), salt=salt)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert 0.2 < 1 - got.mean() < 0.3
    batch = next(iter(BatchPipeline(SyntheticDataset(cfg, "val"), 4)))
    arrays = {k: batch[k] for k in ("x_enc", "index", "valid")}
    jm, tm = jt._with_mask(arrays, salt=salt), tt.with_mask(arrays, salt=salt)
    assert set(jm) == set(tm)
    for k in jm:
        _equal(tm[k], jm[k], k)


# --------------------------------------------------------------------------
# (b) the mask-aware RevIN
# --------------------------------------------------------------------------

def test_masked_window_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 32, 3)) * 3 + 1).astype(np.float32)
    mask = (rng.random((4, 32, 3)) >= 0.3).astype(np.float32)
    mask[1, :, 2] = 0.0  # a channel with no observed point
    mask[2, :, 0] = 1.0
    xm = x * mask
    want = [np.asarray(t) for t in jax_masked_window_norm(jnp.asarray(xm), jnp.asarray(mask))]
    xt = torch.from_numpy(xm).requires_grad_()
    got = masked_window_norm(xt, torch.from_numpy(mask))
    assert not got[1].requires_grad and not got[2].requires_grad  # detached statistics
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.detach().numpy(), w, 1e-6)
    assert not got[0][1, :, 2].any() and got[1][1, 0, 2] == 0.0


# --------------------------------------------------------------------------
# (c) losses and gradients
# --------------------------------------------------------------------------

_TABLE = [("ce", "classification", 2), ("auto", "classification", 3),
          ("cross_entropy", "classification", 3), ("mse", "imputation", 0),
          ("mae", "imputation", 0), ("mse", "forecasting", 0), ("mae", "forecasting", 0),
          ("smooth_l1", "forecasting", 0)]


@pytest.mark.parametrize("name,task,n_classes", _TABLE)
def test_build_loss_matches_jax(name, task, n_classes):
    rng = np.random.default_rng(len(name) + n_classes)
    y = rng.standard_normal((5, 16, 3)).astype(np.float32)
    mask = (rng.random((5, 16, 3)) >= 0.25).astype(np.float32)
    mask[2] = 1.0  # a row with nothing held out
    batch = {"y": y, "mask": mask, "x_enc": y * mask,
             "labels": rng.integers(0, max(n_classes, 2), size=5).astype(np.int64)}
    if task == "classification":
        pred = (rng.standard_normal((5, n_classes)) * 2).astype(np.float32)
    else:
        pred = (y + 0.3 * rng.standard_normal(y.shape)).astype(np.float32)
    _hold_loss(losses.build_loss(name, task, n_classes),
               jlosses.build_loss(name, task, n_classes), pred, batch,
               np.array([True, True, True, False, True]))


@pytest.mark.parametrize("name,task", [
    ("mse", "classification"), ("bce", "classification"), ("jaccard", "classification"),
    ("bce", "imputation"), ("ce", "imputation"), ("smooth_l1", "imputation")])
def test_build_loss_refusals_match_jax(name, task):
    with pytest.raises((ValueError, AssertionError)):
        jlosses.build_loss(name, task, 2)
    with pytest.raises(ValueError, match=task):
        losses.build_loss(name, task, 2)


# --------------------------------------------------------------------------
# (d) the predict -> score chains on the same window predictions
# --------------------------------------------------------------------------

def _window_outputs(case, dataset, seed):
    """The eval step's valid rows as run_eval returns them, with seeded
    predictions shaped as the task's head gives them."""
    rows = list(BatchPipeline(dataset, 4))
    keys = {"forecast": ("x_enc", "y", "index"), "classify": ("labels", "index"),
            "impute": ("x_enc", "index")}[case]
    out = {k: np.concatenate([b[k][b["valid"]] for b in rows]) for k in keys}
    rng = np.random.default_rng(seed)
    if case == "forecast":
        pred = out["y"] + 0.3 * rng.standard_normal(out["y"].shape)
    elif case == "classify":
        n = dataset.n_classes
        pred = rng.standard_normal((len(out["labels"]), n)) + 2 * np.eye(n)[out["labels"]]
    else:
        pred = out["x_enc"] + 0.3 * rng.standard_normal(out["x_enc"].shape)
    out["pred"] = pred.astype(np.float32)
    return out


@pytest.mark.parametrize("step", [16, 24])
def test_forecast_chain_matches_jax(step):
    from medtsllm_tpu.tasks.forecasting import ForecastTask as JF
    from medtsllm_tpu_torch.tasks.forecasting import ForecastTask as TF
    cfg = _cfg("forecast", **{"data.step": step})
    for split in ("val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        out = _window_outputs("forecast", td, 11)
        jt, tt = _bare(JF, cfg, None, out), _bare(TF, cfg, None, out)
        (pj, yj), (pt, yt) = jt.predict(JaxBatchPipeline(jd, 4)), tt.predict(
            BatchPipeline(td, 4))
        _equal(pt, pj, "preds")
        _equal(yt, yj, "targets")
        assert pt.shape[1] == 3 and not np.isnan(pt).any()
        if step > 16 and split == "val":  # the de-duplication kept pred_len of each step
            assert pt.shape[0] == (tt.eval_n_points(td, True) - 32) // step * 16
        assert tt.score(pt, yt) == jt.score(pj, yj)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_classification_chain_matches_jax(n_classes):
    from medtsllm_tpu.tasks.classification import ClassificationTask as JC
    from medtsllm_tpu_torch.tasks.classification import ClassificationTask as TC
    cfg = _cfg("classify", **{"datasets.synthetic.n_classes": n_classes})
    for split in ("val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        out = _window_outputs("classify", td, 13)
        for labels in (out["labels"], np.ones_like(out["labels"])):  # one class: no AUROC
            o = dict(out, labels=labels)
            jt, tt = _bare(JC, cfg, None, o), _bare(TC, cfg, None, o)
            (pj, lj), (pt, lt) = jt.predict(JaxBatchPipeline(jd, 4)), tt.predict(
                BatchPipeline(td, 4))
            _equal(pt, pj, "probs")
            _equal(lt, lj, "labels")
            sj, st_ = jt.score(pj, lj), tt.score(pt, lt)
            assert set(st_) == set(sj) == ({"accuracy", "f1", "precision", "recall"}
                                           | ({"auroc"} if n_classes == 2 else set()))
            for k, v in sj.items():
                if np.isnan(v):
                    assert np.isnan(st_[k]) and k == "auroc"
                else:
                    assert abs(st_[k] - v) <= 1e-12, k


def test_imputation_chain_matches_jax():
    from medtsllm_tpu.tasks.imputation import ImputationTask as JI
    from medtsllm_tpu_torch.tasks.imputation import ImputationTask as TI
    cfg = _cfg("impute")
    for split in ("val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        out = _window_outputs("impute", td, 17)
        jt, tt = _bare(JI, cfg, None, out), _bare(TI, cfg, None, out)
        rj, rt = jt.predict(JaxBatchPipeline(jd, 4)), tt.predict(BatchPipeline(td, 4))
        for got, want, key in zip(rt, rj, ("pred", "target", "mask")):
            _equal(got, want, key)
        assert tt.score(*rt) == jt.score(*rj)


# --------------------------------------------------------------------------
# (e) end to end on copied weights, f32
# --------------------------------------------------------------------------

@functools.cache
def _pair(case, dtype="float32"):
    cfg = _cfg(case, dtype)
    if dtype == "mixed":
        cfg.training.optimizer = "sgd"
        cfg.training.learning_rate = 1e-2
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return case, jt, tt


@pytest.fixture(params=sorted(CASES))
def pair(request):
    return _pair(request.param)


def test_task_end_to_end_matches_jax(pair):
    """The eval step's window outputs of val and test within 1e-5, the
    task's series, then the scores."""
    case, jt, tt = pair
    for pipe_j, pipe_t in ((jt.val_pipeline, tt.val_pipeline),
                           (jt.test_pipeline, tt.test_pipeline)):
        oj = jt.run_eval(pipe_j, extra_keys=("index",))
        ot = tt.run_eval(pipe_t, extra_keys=("index",))
        assert ot["pred"].shape == oj["pred"].shape
        assert ot["pred"].shape[1:] == {"forecast": (16, 3), "classify": (2,),
                                        "impute": (32, 3)}[case]
        _equal(ot["index"], oj["index"])
        _close(ot["pred"], oj["pred"])
        for got, want in zip(tt.predict(pipe_t), jt.predict(pipe_j)):
            _close(got, want)
    for fn in ("val", "test"):
        sj, st_ = getattr(jt, fn)(), getattr(tt, fn)()
        assert set(st_) == set(sj)
        for k, v in sj.items():
            _close(st_[k], v)


def test_imputation_mask_changes_stats():
    """The model reads the observation mask: zeroing half the window with
    the mask differs from treating the zeros as data; both agree with JAX's
    model on the same weights."""
    _, jt, tt = _pair("impute")
    x = np.stack([tt.train_dataset[0]["x_enc"]] * 2)
    mask = np.ones_like(x)
    mask[:, ::2, :] = 0.0
    xm = x * mask
    arrays = {"x_enc": xm, "mask": mask}
    with torch.inference_mode():
        with_mask = tt.model({k: torch.from_numpy(v) for k, v in arrays.items()}).numpy()
        without = tt.model({"x_enc": torch.from_numpy(xm)}).numpy()
    assert with_mask.shape == without.shape == x.shape
    assert not np.allclose(with_mask, without)
    for got, inputs in ((with_mask, arrays), (without, {"x_enc": xm})):
        want = np.asarray(jt.model.apply({"params": jt.params},
                                         {k: jnp.asarray(v) for k, v in inputs.items()},
                                         training=False))
        _close(got, want)


def test_step_key_takes_the_mask():
    """Imputation's eval inputs carry ``mask`` and ``y`` into the captured
    step: both are in its key with their shapes."""
    _, _, tt = _pair("impute")
    batches = iter(tt.test_pipeline)
    kind, arrays = tt.eval_prepare(next(batches))
    assert kind == "plain"
    key = dict((k[0], k[1:]) for k in step_key(arrays))
    assert key["mask"] == ((4, 32, 3), torch.float32) == key["y"] == key["x_enc"]
    assert not arrays["x_enc"][arrays["mask"] == 0].any()
    assert step_key(tt.eval_prepare(next(batches))[1]) == step_key(arrays)
    assert step_key(dict(arrays, mask=arrays["mask"][:, :16])) != step_key(arrays)


# --------------------------------------------------------------------------
# (f) under mixed
# --------------------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_eval_matches_jax(case):
    _, jt, tt = _pair(case, "mixed")
    for pj, pt in ((jt.val_pipeline, tt.val_pipeline), (jt.test_pipeline, tt.test_pipeline)):
        want, got = jt.run_eval(pj)["pred"], tt.run_eval(pt)["pred"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_train_steps_match_jax(case):
    """Three SGD steps on the same shuffled batches (forecasting and
    classification serve the head from the train cache, imputation embeds
    it, on both sides); the backbone stays put."""
    _, jt, shared = _pair(case, "mixed")
    tt = get_trainer("port-train", shared.config, device="cpu")  # fresh optimizer state
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jpipe = JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)
    tpipe = BatchPipeline(tt.train_dataset, 4, shuffle=True, seed=0)
    head = "prefix_ids" if case == "impute" else "prefix_kv"
    for step, (jb, tb) in enumerate(zip(jpipe, tpipe)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert head in ja and head in ta
        if case == "impute":
            _equal(ta["mask"].numpy(), ja["mask"], "mask")
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        loss_tol = 2.0 ** -5 if case == "classify" else 2.0 ** -7  # (f)
        assert abs(float(loss_t) - float(loss_j)) <= loss_tol * abs(float(loss_j))
    want, got = from_flax(jax.device_get(params)), tt.model.state_dict()
    moves = {}
    for k in got:
        if k.startswith("llm."):
            assert torch.equal(got[k], start[k]), k
            continue
        assert got[k].dtype == torch.float32
        moves[k] = np.abs(_np(want[k]) - _np(start[k])).max()
    largest = max(moves.values())
    for k, move in moves.items():
        err = np.abs(_np(got[k]) - _np(want[k])).max()
        if k.endswith("key_projection.bias"):  # an exactly-zero gradient
            port_move = np.abs(_np(got[k]) - _np(start[k])).max()
            assert max(move, port_move) <= 1e-3 * largest, k
            continue
        tol = 2.0 ** -4 if case == "classify" else 2.0 ** -5  # (f)
        if k == "mapping_layer.bias":
            tol = 2.0 ** -3 if case == "forecast" else 2.0 ** -4
        assert move > 0 and err <= tol * move, (k, err, move)


def _first_train_step(case):
    """(jt, tt, JAX's inputs, the port's, valid) on the first shuffled
    train batch of a fresh port trainer holding JAX's weights."""
    _, jt, shared = _pair(case, "mixed")
    tt = get_trainer("port-gap", shared.config, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    jb = next(iter(JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)))
    tb = next(iter(BatchPipeline(tt.train_dataset, 4, shuffle=True, seed=0)))
    return jt, tt, jt.train_model_inputs(jb), tt.train_model_inputs(tb), jb["valid"]


def _jax_train_pred(jt, params, ja, intercept=None):
    """JAX's train-step forward (frozen leaves stopped, bf16 casts), f32."""
    params = jax.tree.map(lambda x, l: jax.lax.stop_gradient(x) if l == "frozen" else x,
                          params, jt.param_label_tree)
    with fnn.intercept_methods(intercept or (lambda f, a, k, c: f(*a, **k))):
        pred = jt.model.apply({"params": jt._cast_for_compute(params)},
                              jt._cast_for_compute(ja), training=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
    return pred.astype(jnp.float32)


def test_classification_loss_gap_is_the_logits():
    """(f) The first mixed train step's loss: each package's loss function
    on the other's train-mode logits gives the other's loss (the same
    function), so the gap is the logits' alone, and it is within the
    cross-entropy's bound 2 max |d logits| (its gradient in the logits has
    an L1 norm of at most 2 a row). The logits, two bf16 sums a row with no
    RevIN denorm, agree within 2^-5 of their largest: a relative gap the
    mean over B rows carries into the loss, where a regression loss
    averages the rounding of B x L x C outputs. The logits' cotangent,
    (softmax - one-hot) / n_valid a valid row, of which every parameter's
    gradient is a linear image, moves by at most max |d logits| / (2
    n_valid) (softmax's Jacobian has an infinity norm of at most 1/2), and
    so carries the logits' relative gap into every gradient."""
    jt, tt, ja, ta, valid = _first_train_step("classify")
    zj = np.asarray(_jax_train_pred(jt, jt.params, ja))
    tt.model.train()
    try:
        with torch.no_grad():
            params = {n: _cast(p, torch.bfloat16) for n, p in tt.model.named_parameters()}
            zt = torch.func.functional_call(tt.model, params, (_cast(ta, torch.bfloat16),),
                                            {"generator": tt.dropout_generator}).float()
    finally:
        tt.model.eval()
    zt = zt.numpy()
    assert zt.shape == zj.shape == (4, 2)
    valid_j, valid_t = jnp.asarray(valid), torch.from_numpy(valid)
    loss_j = float(jt.loss_fn(jnp.asarray(zj), ja, valid_j))
    loss_t = float(tt.train_step(ta, ta["valid"]))
    for z, want in ((zj, loss_j), (zt, loss_t)):
        got_t = float(tt.loss_fn(torch.from_numpy(z), ta, valid_t))
        got_j = float(jt.loss_fn(jnp.asarray(z), ja, valid_j))
        assert abs(got_t - want) <= 1e-6 and abs(got_j - want) <= 1e-6
    dz = np.abs(zt - zj).max()
    assert abs(loss_t - loss_j) <= 2 * dz
    assert dz <= 2.0 ** -5 * np.abs(zj).max()
    gj = np.asarray(jax.grad(lambda z: jt.loss_fn(z, ja, valid_j))(jnp.asarray(zj)))
    zg = torch.from_numpy(zt).requires_grad_()
    tt.loss_fn(zg, ta, valid_t).backward()
    gt = zg.grad.numpy()
    assert np.abs(gt - gj).max() <= dz / (2 * valid.sum()) + 1e-7
    assert np.abs(gt - gj).max() <= 2.0 ** -5 * np.abs(gj).max()


def test_mapping_bias_gradient_gap_forecast():
    """(f) tests/test_torch_mixed.py's decomposition on forecasting's first
    mixed train step: the cotangents of the mapping layer's output agree
    within 2^-5 of the largest; JAX's bias gradient is exactly its
    cotangent summed as XLA's CPU backend sums a bf16 reduction, the
    port's exactly its own summed at f32 and rounded once; and the sum
    cancels to under 2^-3 of its terms' magnitudes, which magnifies both
    the cotangents' gap and the order of summation."""
    jt, tt, ja, ta, valid = _first_train_step("forecast")
    ml = tt.model.mapping_layer
    d_llm, n_tokens = tt.model.llm_cfg.d_model, ml.out_features

    def loss_j(params, delta):
        def add_delta(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            return out + delta.astype(out.dtype) if context.module.name == "mapping_layer" \
                else out
        pred = _jax_train_pred(jt, params, ja, add_delta)
        return jt.loss_fn(pred, ja, jnp.asarray(valid))
    loss_jax, (grads, cot) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jt.params, jnp.zeros((d_llm, n_tokens), jnp.float32))
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
    assert np.abs(cot_j.sum(0)).max() <= 2.0 ** -3 * np.abs(cot_j).sum(0).max()


# --------------------------------------------------------------------------
# (g) every task runs under both dtypes; the refusals' wording
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_val_test_run(case, dtype):
    tt = get_trainer("port", _cfg(case, dtype), device="cpu")
    tt.train()
    assert len(tt.losses) == len(tt.train_pipeline) and all(np.isfinite(tt.losses))
    assert len(tt.val_scores) == 1 and np.isfinite(tt.best_score)
    scores = tt.test()
    want = {"forecast": {"mse", "mae"}, "impute": {"masked_mse", "masked_mae", "full_mse"},
            "classify": {"accuracy", "f1", "precision", "recall", "auroc"}}[case]
    assert set(scores) == {f"test/{k}" for k in want}
    assert all(np.isfinite(v) for v in scores.values())


def test_no_refusal_names_an_item_number():
    """No ``NotImplementedError`` message of the port names a ROADMAP item
    by a number that a later roadmap renumbers: no string in the package
    (the messages, the parts they are joined from, the docstrings) says
    "item N"; each names its item by title."""
    root = Path(__file__).resolve().parents[1] / "medtsllm_tpu_torch"
    n_raises, titled, bad = 0, 0, []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call) and getattr(
                    node.exc.func, "id", None) == "NotImplementedError":
                n_raises += 1
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                titled += 'queue 1, "' in node.value
                if re.search(r"\bitems? \d+", node.value):
                    bad.append(f"{path.relative_to(root)}:{node.lineno}")
    # (the floors guard the scan itself: 14 raises and 17 titled strings since
    # MedTsLLM's remaining modes stopped refusing)
    assert n_raises >= 14 and titled >= 17 and not bad, (n_raises, titled, bad)
