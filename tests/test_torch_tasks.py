"""The port's segmentation, anomaly-detection and semantic-segmentation
tasks against the JAX package, on the CPU, in f32:

  (a) the synthetic data with labels: every split's windows, labels,
      ``x_starts`` and ``n_classes`` bit-equal with JAX's ``get_dataset``,
      and the batches of both pipelines;
  (b) post-processing on identical numpy inputs: ``adjust_anomalies``
      (against JAX's native path and its numpy path), ``points_to_segments``,
      ``all_pairs_iou``, ``running_mean``, ``smooth_scores`` and
      ``find_peaks_threshold`` exactly equal;
  (c) the metrics against ``sklearn.metrics`` within 1e-12 over drawn
      label / prediction pairs, binary and 4-class, ``roc_auc`` with ties,
      and the degenerate cases (one class only, no predicted positives);
  (d) the losses and their gradients against ``jax.grad`` within 1e-6 of
      the largest, with masked rows; ``build_loss``'s table;
  (e) each task's predict -> score chain on the same window predictions
      (the eval step's output replaced by seeded numpy arrays): the
      stitched series, ``pred_points``, the anomaly quantile and threshold
      and every metric equal to JAX's, AUROC within 1e-12 (the port ranks,
      sklearn integrates the ROC curve: the same number up to rounding);
  (f) each task end to end on weights copied by ``weights.from_flax``:
      the port's stitched ``val()`` / ``test()`` predictions within 1e-5
      of JAX's (dense f32: summation order only) and the same scores;
  (g) ``train()``, ``val()`` and ``test()`` of every case under float32 and
      mixed, and the refusals that remain.

Sizes: llama-tiny, 2 layers, 300 synthetic points, history 32.
"""

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics as skm
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import medtsllm_tpu.native as jnative
from conftest import make_config
from medtsllm_tpu.data import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.data import get_dataset as jax_get_dataset
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu.tasks import losses as jlosses
from medtsllm_tpu.tasks import postproc as jpost
from medtsllm_tpu_torch.data import BatchPipeline, SyntheticDataset
from medtsllm_tpu_torch.tasks import get_trainer, losses, metrics, postproc
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

# case -> (task, loss, eval metric and direction, overrides)
CASES = {
    "seg-boundary": ("segmentation", "bce", ("segment_miou", "max"), {}),
    "seg-steps": ("segmentation", "mse", ("segment_miou", "max"),
                  {"tasks.segmentation.mode": "steps-to-boundary"}),
    "anomaly": ("anomaly_detection", "mse", ("recon_mse", "min"),
                {"tasks.anomaly_detection.normalize_by_feature": True}),
    "semseg-2": ("semantic_segmentation", "bce", ("iou", "max"), {}),
    "semseg-4": ("semantic_segmentation", "ce", ("iou", "max"),
                 {"datasets.synthetic.n_classes": 4}),
}


def _cfg(case, dtype="float32", **extra):
    task, loss, (metric, direction), over = CASES[case]
    cfg = make_config(task=task, model="medtsllm", hist=32, pred=32, step=16, loss=loss,
                      eval_metric=metric, eval_dir=direction, **{**over, **extra})
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 300
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": False,
                      "examples": False, "input_stats_dim": 0,
                      "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2,
                "prefix_cache": True, "load_in_4bit": False, "load_in_8bit": False}}}
    return cfg


# --------------------------------------------------------------------------
# (a) the data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_data_matches_jax(case, split):
    cfg = _cfg(case)
    jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
    assert len(td) == len(jd) > 0 and td.n_classes == jd.n_classes
    assert td.n_features == td.real_features == jd.real_features == 3
    assert td.data.dtype == jd.data.dtype and np.array_equal(td.data, jd.data)
    if jd.labels is None:  # anomaly detection's train split
        assert td.labels is None and case == "anomaly" and split == "train"
    else:
        assert td.labels.dtype == jd.labels.dtype
        assert np.array_equal(td.labels, jd.labels)
    idx = np.arange(len(jd))
    assert np.array_equal(td.x_starts(idx), jd.x_starts(idx))
    n = 0
    for jb, tb in zip(JaxBatchPipeline(jd, 4), BatchPipeline(td, 4)):
        assert set(jb) == set(tb)
        for k in jb:
            assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype, k
            assert np.array_equal(tb[k], jb[k]), k
        n += 1
    assert n == len(BatchPipeline(td, 4))


def test_semseg_four_classes_and_segment_labels():
    """The label content the tasks rely on: four classes in turn, boundary
    indicators, distances in (0, 1] falling to 0 at each boundary."""
    assert set(np.unique(SyntheticDataset(_cfg("semseg-4"), "val").labels)) == {0, 1, 2, 3}
    b = SyntheticDataset(_cfg("seg-boundary"), "val").labels
    d = SyntheticDataset(_cfg("seg-steps"), "val").labels
    assert set(np.unique(b)) == {0, 1} and b.sum() >= 2
    assert d.dtype == np.float32 and (d >= 0).all() and (d <= 1).all()
    assert np.array_equal(np.flatnonzero(d == 0), np.flatnonzero(b))


# --------------------------------------------------------------------------
# (b) post-processing
# --------------------------------------------------------------------------

_bits = st.lists(st.integers(0, 1), min_size=1, max_size=120)


@settings(max_examples=80, deadline=None, database=None)
@given(pred=_bits, gt=_bits, gt0=st.booleans())
def test_adjust_anomalies_matches_native_and_numpy(pred, gt, gt0):
    n = min(len(pred), len(gt))
    pred, gt = np.array(pred[:n]), np.array(gt[:n])
    gt[0] = int(gt0)  # the index-0 quirk, both ways
    got = postproc.adjust_anomalies(pred, gt)
    assert got.dtype == np.int64
    native = jnative.adjust_anomalies_native(pred.astype(np.int32), gt.astype(np.int32))
    assert native is not None  # the JAX package's C++ path is built here
    assert np.array_equal(got, native.astype(np.int64))
    saved = jnative.adjust_anomalies_native
    jnative.adjust_anomalies_native = lambda *a: None  # JAX's numpy path
    try:
        assert np.array_equal(got, jpost.adjust_anomalies(pred, gt))
    finally:
        jnative.adjust_anomalies_native = saved


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.floats(-1e3, 1e3), min_size=1, max_size=80), st.integers(1, 12))
def test_running_mean_and_smoothing_match(xs, window):
    xs = np.array(xs)
    assert np.array_equal(postproc.running_mean(xs, window), jpost.running_mean(xs, window))
    for method in ("mean", "max", "none"):
        assert np.array_equal(postproc.smooth_scores(xs, window, method),
                              jpost.smooth_scores(xs, window, method))
    for q in (0.3, 0.5, 0.9):
        assert np.array_equal(postproc.find_peaks_threshold(xs, q),
                              jpost.find_peaks_threshold(xs, q))


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(1, 500), max_size=12, unique=True),
       st.lists(st.integers(1, 500), max_size=12, unique=True))
def test_segments_and_iou_match(p1, p2):
    n = 502
    s1 = postproc.points_to_segments(np.sort(p1), n)
    s2 = postproc.points_to_segments(np.sort(p2), n)
    assert np.array_equal(s1, jpost.points_to_segments(np.sort(p1), n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # empty segments give 0 / 0, in both
        got, want = postproc.all_pairs_iou(s1, s2), jpost.all_pairs_iou(s1, s2)
    assert np.array_equal(got, want, equal_nan=True)


# --------------------------------------------------------------------------
# (c) metrics against sklearn
# --------------------------------------------------------------------------

_SK = {"precision": skm.precision_score, "recall": skm.recall_score, "f1": skm.f1_score,
       "jaccard": skm.jaccard_score}


def _hold_metrics(y_true, y_pred, average):
    assert abs(metrics.accuracy(y_true, y_pred) - skm.accuracy_score(y_true, y_pred)) <= 1e-12
    for name, fn in _SK.items():
        want = fn(y_true, y_pred, average=average, zero_division=0)
        got = getattr(metrics, name)(y_true, y_pred, average)
        assert abs(got - want) <= 1e-12, (name, average, got, want)


@settings(max_examples=100, deadline=None, database=None)
@given(st.integers(2, 4).flatmap(lambda k: st.tuples(
    st.just(k), st.lists(st.tuples(st.integers(0, k - 1), st.integers(0, k - 1)),
                         min_size=1, max_size=60))))
def test_metrics_match_sklearn(drawn):
    k, pairs = drawn
    y_true, y_pred = np.array(pairs).T
    _hold_metrics(y_true, y_pred, "binary" if k == 2 else "macro")
    if k == 2:
        _hold_metrics(y_true, y_pred, "macro")


@settings(max_examples=100, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 1), st.integers(0, 6)), min_size=2, max_size=80),
       st.booleans())
def test_roc_auc_matches_sklearn(pairs, continuous):
    y, s = np.array(pairs).T
    s = s.astype(np.float64) * (0.37 if continuous else 1.0)  # few values: many ties
    if len(np.unique(y)) < 2:
        with pytest.raises(ValueError):
            metrics.roc_auc(y, s)
        return
    assert abs(metrics.roc_auc(y, s) - skm.roc_auc_score(y, s)) <= 1e-12


def test_metrics_degenerate_cases():
    """One class only; no predicted positives; no true positives."""
    for y_true, y_pred in (([0, 0, 0], [0, 0, 0]), ([1, 1, 1], [1, 1, 1]),
                           ([0, 1, 1, 0], [0, 0, 0, 0]), ([0, 0, 0, 0], [0, 1, 0, 1]),
                           ([3, 3, 3], [3, 3, 3]), ([2, 2, 0], [1, 1, 1])):
        avg = "binary" if set(y_true) | set(y_pred) <= {0, 1} else "macro"
        _hold_metrics(np.array(y_true), np.array(y_pred), avg)
    assert metrics.precision([0, 1, 1, 0], [0, 0, 0, 0]) == 0.0
    with pytest.raises(ValueError):
        metrics.f1([0, 2], [0, 1], "binary")


# --------------------------------------------------------------------------
# (d) losses and gradients
# --------------------------------------------------------------------------

def _loss_inputs(seed, n_classes):
    rng = np.random.default_rng(seed)
    shape = (5, 16, n_classes) if n_classes > 2 else (5, 16)
    pred = (rng.standard_normal(shape) * 2).astype(np.float32)
    labels = rng.integers(0, max(n_classes, 2), size=(5, 16)).astype(np.int32)
    x = rng.standard_normal((5, 16, 3)).astype(np.float32)
    valid = np.array([True, True, False, True, False])
    return pred, labels, x, valid


def _hold_loss(fn_t, fn_j, pred, batch, valid):
    """Value and gradient w.r.t. the predictions, 1e-6 of the largest."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, gj = jax.value_and_grad(lambda p: fn_j(p, jb, jnp.asarray(valid)))(
        jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_()
    got = fn_t(pt, {k: torch.from_numpy(v) for k, v in batch.items()},
               torch.from_numpy(valid))
    got.backward()
    gj = np.asarray(gj)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt.grad.numpy(), gj, rtol=1e-6,
                               atol=1e-6 * max(np.abs(gj).max(), 1e-6))
    assert not pt.grad[~torch.from_numpy(valid)].any()  # masked rows carry none


# (loss, task, n_classes): every row of build_loss's table these tasks reach
_TABLE = [("bce", "segmentation", 0), ("mse", "segmentation", 0),
          ("mae", "segmentation", 0), ("smooth_l1", "segmentation", 0),
          ("mse", "anomaly_detection", 0),
          ("mae", "anomaly_detection", 0), ("smooth_mae", "anomaly_detection", 0),
          ("bce", "semantic_segmentation", 2), ("ce", "semantic_segmentation", 2),
          ("auto", "semantic_segmentation", 2), ("jaccard", "semantic_segmentation", 2),
          ("lovasz", "semantic_segmentation", 2), ("lovasz-hinge", "semantic_segmentation", 2),
          ("ce", "semantic_segmentation", 4), ("cross_entropy", "semantic_segmentation", 4),
          ("iou", "semantic_segmentation", 4), ("mse", "semantic_segmentation", 2),
          ("mse", "reconstruction", 0)]


@pytest.mark.parametrize("name,task,n_classes", _TABLE)
def test_build_loss_matches_jax(name, task, n_classes):
    pred, labels, x, valid = _loss_inputs(len(name) + n_classes, n_classes)
    if task in ("reconstruction", "anomaly_detection"):
        pred = x + pred[..., None] * 0.1
    if task == "segmentation" and name != "bce":
        labels = labels.astype(np.float32) * 0.5  # steps-to-boundary targets
    _hold_loss(losses.build_loss(name, task, n_classes),
               jlosses.build_loss(name, task, n_classes), pred,
               {"labels": labels, "x_enc": x}, valid)


@pytest.mark.parametrize("name,task,n_classes", [
    ("bce", "anomaly_detection", 0), ("ce", "segmentation", 0),
    ("lovasz", "segmentation", 0), ("bce", "semantic_segmentation", 4),
    ("lovasz", "semantic_segmentation", 4), ("bce", "reconstruction", 0)])
def test_build_loss_refusals_match_jax(name, task, n_classes):
    with pytest.raises(ValueError):
        jlosses.build_loss(name, task, n_classes)
    with pytest.raises(ValueError, match="Invalid loss"):
        losses.build_loss(name, task, n_classes)


def test_lovasz_and_jaccard_with_ties():
    """Tied hinge errors (repeated logits) sort stably in both."""
    rng = np.random.default_rng(3)
    pred = rng.choice([-1.0, 0.0, 0.5, 2.0], size=(4, 24)).astype(np.float32)
    labels = rng.integers(0, 2, size=(4, 24)).astype(np.int32)
    valid = np.array([True, False, True, True])
    for fn_t, fn_j in ((losses.lovasz_hinge, jlosses.lovasz_hinge),
                       (losses.jaccard_loss, jlosses.jaccard_loss)):
        _hold_loss(lambda p, b, v, f=fn_t: f(p, b["labels"], v),
                   lambda p, b, v, f=fn_j: f(p, b["labels"], v), pred,
                   {"labels": labels}, valid)


# --------------------------------------------------------------------------
# (e) the predict -> score chains on the same window predictions
# --------------------------------------------------------------------------

def _bare(cls, cfg, train_dataset, out):
    """A task object with its config, the train dataset and ``run_eval``
    returning ``out``: the post-processing alone, no model."""
    obj = object.__new__(cls)
    obj.config, obj.train_dataset = cfg, train_dataset
    if cfg.task == "segmentation":
        obj.segmentation_mode = cfg.tasks.segmentation.mode
    if cfg.task == "anomaly_detection":
        obj.task_config = cfg.tasks.anomaly_detection
    obj.run_eval = lambda pipeline, extra_keys=(): {k: out[k] for k in ("pred", *extra_keys)}
    return obj


def _window_outputs(case, dataset, seed):
    """The eval step's valid rows as run_eval returns them, with seeded
    predictions shaped as the task's head gives them."""
    rows = [b for b in BatchPipeline(dataset, 4)]
    out = {k: np.concatenate([b[k][b["valid"]] for b in rows])
           for k in ("x_enc", "labels", "index")}
    rng = np.random.default_rng(seed)
    n, L = out["labels"].shape
    lab = out["labels"].astype(np.float32)
    if case == "seg-boundary":  # boundary bumps under noise
        pred = 1 / (1 + np.exp(-(4 * lab - 2 + rng.standard_normal((n, L)))))
    elif case == "seg-steps":
        pred = lab + 0.1 * rng.standard_normal((n, L))
    elif case == "anomaly":
        pred = out["x_enc"] + 0.3 * rng.standard_normal(out["x_enc"].shape)
    elif case == "semseg-2":
        pred = 1 / (1 + np.exp(-(3 * lab - 1.5 + rng.standard_normal((n, L)))))
    else:
        logits = rng.standard_normal((n, L, 4)) + 2 * np.eye(4)[out["labels"]]
        pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    out["pred"] = pred.astype(np.float32)
    return out


def _equal(got, want, key=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want), key


_AD_VARIANTS = {"auto-nbf": {}, "fixed-window": {
    "tasks.anomaly_detection.threshold": 0.05,
    "tasks.anomaly_detection.normalize_moving_window": 9,
    "tasks.anomaly_detection.normalize_by_feature": False}, "int-threshold": {
    "tasks.anomaly_detection.threshold": 1}}


@pytest.mark.parametrize("split", ["val", "test"])
@pytest.mark.parametrize("variant", sorted(_AD_VARIANTS))
def test_anomaly_chain_matches_jax(variant, split):
    from medtsllm_tpu.tasks.anomaly_detection import AnomalyDetectionTask as JAD
    from medtsllm_tpu_torch.tasks.anomaly_detection import AnomalyDetectionTask as TAD
    cfg = _cfg("anomaly", **_AD_VARIANTS[variant])
    jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
    out = _window_outputs("anomaly", td, 5)
    jt = _bare(JAD, cfg, jax_get_dataset(cfg, "train"), out)
    tt = _bare(TAD, cfg, SyntheticDataset(cfg, "train"), out)
    rj = jt.predict(JaxBatchPipeline(jd, 4), split=split)
    rt = tt.predict(BatchPipeline(td, 4))
    assert set(rt) == set(rj.to_dict())
    for k in rt:
        _equal(rt[k], rj[k], k)
    assert rt["anomaly_labels"].sum() > 0 and rt["anomaly_preds"].sum() > 0
    sj = jt.score_anomalies(rj.anomaly_preds, rj.anomaly_labels, scores=rj.anomaly_scores)
    st_ = tt.score_anomalies(rt["anomaly_preds"], rt["anomaly_labels"],
                             scores=rt["anomaly_scores"])
    assert set(st_) == set(sj)
    for k in sj:
        if k == "auroc":  # ranks against the integrated ROC curve
            assert abs(st_[k] - sj[k]) <= 1e-12
        else:
            assert st_[k] == sj[k], k
    assert tt.score(rt["recon_preds"], rt["recon_targets"]) == jt.score(
        rj.recon_preds, rj.recon_targets)


@pytest.mark.parametrize("thresh", ["auto", 40])
@pytest.mark.parametrize("case", ["seg-boundary", "seg-steps"])
def test_segmentation_chain_matches_jax(case, thresh):
    from medtsllm_tpu.tasks.segmentation import SegmentationTask as JSeg
    from medtsllm_tpu_torch.tasks.segmentation import SegmentationTask as TSeg
    cfg = _cfg(case, **{"tasks.segmentation.distance_thresh": thresh})
    for split in ("val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        out = _window_outputs(case, td, 7)
        jt, tt = _bare(JSeg, cfg, None, out), _bare(TSeg, cfg, None, out)
        rj, rt = jt.predict(JaxBatchPipeline(jd, 4)), tt.predict(BatchPipeline(td, 4))
        assert set(rt) == set(rj)
        for k in rj:
            _equal(rt[k], rj[k], k)
        assert len(rt["pred_points"]) > 0
        assert tt.score(rt) == jt.score(rj)
    # the degenerate schema: no predicted point
    empty = dict(rt, pred_points=np.zeros(0, np.int64))
    assert tt.score(empty) == jt.score(empty)


@pytest.mark.parametrize("case", ["semseg-2", "semseg-4"])
def test_semseg_chain_matches_jax(case):
    from medtsllm_tpu.tasks.semantic_segmentation import SemanticSegmentationTask as JSS
    from medtsllm_tpu_torch.tasks.semantic_segmentation import (
        SemanticSegmentationTask as TSS)
    cfg = _cfg(case)
    for split in ("val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        out = _window_outputs(case, td, 9)
        jt, tt = _bare(JSS, cfg, None, out), _bare(TSS, cfg, None, out)
        (pj, lj), (pt, lt) = jt.predict(JaxBatchPipeline(jd, 4)), tt.predict(
            BatchPipeline(td, 4))
        _equal(pt, pj, "preds")
        _equal(lt, lj, "labels")
        assert tt.score(pt, lt) == jt.score(pj, lj)


# --------------------------------------------------------------------------
# (f) end to end on copied weights, f32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    cfg = _cfg(request.param)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return request.param, jt, tt


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def test_task_end_to_end_matches_jax(pair):
    """The eval step's window outputs and the stitched series of val and
    test within 1e-5; the scores: every count-based metric equal (the
    peaks, thresholds and classes come out the same), the continuous ones
    (errors, the threshold, AUROC, point distances) within 1e-5."""
    case, jt, tt = pair
    for pipe_j, pipe_t in ((jt.val_pipeline, tt.val_pipeline),
                           (jt.test_pipeline, tt.test_pipeline)):
        oj = jt.run_eval(pipe_j, extra_keys=("index",))
        ot = tt.run_eval(pipe_t, extra_keys=("index",))
        assert ot["pred"].shape == oj["pred"].shape
        assert ot["pred"].shape[1:] == {"anomaly": (32, 3), "semseg-4": (32, 4)}.get(
            case, (32,))
        _equal(ot["index"], oj["index"])
        _close(ot["pred"], oj["pred"])
        if case.startswith("seg"):
            rj, rt = jt.predict(pipe_j), tt.predict(pipe_t)
            _close(rt["preds_raw"], rj["preds_raw"])
            _equal(rt["pred_points"], rj["pred_points"], "pred_points")
        elif case == "anomaly":
            rj, rt = jt.predict(pipe_j, split="test"), tt.predict(pipe_t)
            _close(rt["recon_preds"], rj.recon_preds)
            _equal(rt["anomaly_preds"], rj.anomaly_preds, "anomaly_preds")
        else:
            (pj, _), (pt, _) = jt.predict(pipe_j), tt.predict(pipe_t)
            _close(pt, pj)
    for fn in ("val", "test"):
        sj, st_ = getattr(jt, fn)(), getattr(tt, fn)()
        assert set(st_) == set(sj)
        for k, v in sj.items():
            _close(st_[k], v)


def test_stitched_outputs_are_task_shaped(pair):
    """Scores in [0, 1] for the sigmoid / softmax heads; anomaly detection
    reconstructs in data units (RevIN denorm)."""
    case, _, tt = pair
    pred = tt.run_eval(tt.test_pipeline)["pred"]
    if case in ("seg-boundary", "semseg-2", "semseg-4"):
        assert (pred >= 0).all() and (pred <= 1).all()
    if case == "semseg-4":
        np.testing.assert_allclose(pred.sum(-1), 1.0, rtol=1e-5)
    if case == "anomaly":
        assert np.abs(pred).max() > 1.0


# --------------------------------------------------------------------------
# (g) every case runs under both dtypes; what still raises
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_val_test_run(case, dtype):
    tt = get_trainer("port", _cfg(case, dtype), device="cpu")
    tt.train()
    assert len(tt.losses) == len(tt.train_pipeline) and all(np.isfinite(tt.losses))
    assert len(tt.val_scores) == 1 and np.isfinite(tt.best_score)
    scores = tt.test()
    assert scores and all(k.startswith("test/") for k in scores)
    assert all(np.isfinite(v) for k, v in scores.items() if not k.endswith(("mae", "rmse")))


@pytest.mark.parametrize("name", ["bidmc", "ecgmit-anom", "ecgmit-seg", "ludb", "ventilator"])
def test_shipped_configs_load_and_validate(name):
    """The port's TOML loader reads each shipped dataset config as the JAX
    package's does, and its checks pass where JAX's do."""
    from medtsllm_tpu.config import load_config as jax_load_config
    from medtsllm_tpu.config import validate_config as jax_validate
    from medtsllm_tpu_torch.config import load_config, validate_config
    path = Path(__file__).resolve().parents[1] / "configs" / "datasets" / f"{name}.toml"
    got, want = load_config(path), jax_load_config(str(path))
    assert got.to_dict() == want.to_dict()
    jax_validate(want)
    validate_config(got)
    assert got.setup.dtype == "mixed" and got.task in (
        "segmentation", "anomaly_detection", "semantic_segmentation")
    broken = dict(got.to_dict(), pred_len=got.history_len + 1)
    with pytest.raises(ValueError, match="history_len == pred_len"):
        validate_config(type(got)(broken))


def test_remaining_refusals_name_their_roadmap_items():
    """The Bayesian optimize thresholds, clip datasets and pretraining are
    ported (tests/test_torch_bayesopt.py, test_torch_clip.py,
    test_torch_pretraining.py): each builds and scores; the refusals that
    remain name their item."""
    cfg = _cfg("seg-boundary", **{"tasks.segmentation.distance_thresh": "optimize"})
    scores = get_trainer("x", cfg, device="cpu").test()
    assert np.isfinite(scores["test/segment_miou"])
    for thr in ("optimize", "optimize-test"):
        cfg = _cfg("anomaly", **{"tasks.anomaly_detection.threshold": thr})
        scores = get_trainer("x", cfg, device="cpu").test()
        assert 0.5 <= scores["test/anomaly_quantile"] <= 1.0
    cfg = _cfg("semseg-2", **{"datasets.synthetic.clips": True})
    assert get_trainer("x", cfg, device="cpu").test_dataset.clip_dataset  # ported
    cfg = _cfg("anomaly", **{"tasks.pretraining": {"downsample_pct": 0.002,
                                                   "n_features": "auto"}})
    cfg.task = "pretraining"
    assert get_trainer("x", cfg, device="cpu").test_dataset.name == (
        "pretrain:ECG+ventilator+bidmc+ludb")
    cfg = _cfg("semseg-2")
    cfg.models.medtsllm.prompting.examples = True
    with pytest.raises(NotImplementedError, match="\"MedTsLLM's remaining modes\""):
        get_trainer("x", cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            get_trainer("x", _cfg("seg-boundary", "mixed"), device="cuda")
