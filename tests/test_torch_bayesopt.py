"""The port's Bayesian threshold search (``tasks/bayesopt.py``, numpy and
scipy) against scikit-learn and the JAX package, on the CPU:

  (a) ``GaussianProcess`` against ``sklearn.gaussian_process.
      GaussianProcessRegressor(kernel=Matern(nu=2.5), alpha=1e-6,
      normalize_y=True, n_restarts_optimizer=2, random_state=0)`` fitted
      on the same points (random, duplicated, a constant target, the
      plateaus of an F1 curve): the fitted length scale within 1e-6
      relative, the posterior mean and standard deviation at 512 points
      within 1e-8; the kernel and its gradient against scikit-learn's
      ``Matern``;
  (b) ``BayesianOptimization`` against the JAX package's on the same
      objective: the same points evaluated, the same maximum (1e-12);
  (c) segmentation's and anomaly detection's ``optimize_threshold``
      against JAX's on the same scores (the same candidate, within 1e-12),
      and the ``"optimize"`` / ``"optimize-test"`` chains of both tasks on
      the same window predictions equal to JAX's, scores included.
"""

import warnings

import numpy as np
import pytest
from sklearn.gaussian_process import GaussianProcessRegressor
from sklearn.gaussian_process.kernels import Matern

from medtsllm_tpu.data import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.data import get_dataset as jax_get_dataset
from medtsllm_tpu.tasks import anomaly_detection as jad
from medtsllm_tpu.tasks import bayesopt as jbo
from medtsllm_tpu.tasks import segmentation as jseg
from medtsllm_tpu_torch.data import BatchPipeline, SyntheticDataset
from medtsllm_tpu_torch.tasks import anomaly_detection as tad
from medtsllm_tpu_torch.tasks import bayesopt as tbo
from medtsllm_tpu_torch.tasks import segmentation as tseg
from test_torch_tasks import _bare, _cfg, _equal, _window_outputs


def _sklearn_gp():
    return GaussianProcessRegressor(kernel=Matern(nu=2.5), alpha=1e-6, normalize_y=True,
                                    n_restarts_optimizer=2, random_state=0)


def _points(kind, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.5, 1.0, size=(n, 1))
    if kind == "random":
        y = np.sin(12 * X[:, 0]) + 0.1 * rng.standard_normal(n)
    elif kind == "duplicates":
        X[n // 2:] = X[:n - n // 2]
        y = np.cos(9 * X[:, 0]) + 0.05 * rng.standard_normal(n)
    elif kind == "constant":
        y = np.full(n, 0.25)
    else:  # the plateaus of an F1 curve over a quantile
        y = np.round(np.clip(1.8 - 2 * np.abs(X[:, 0] - 0.9), 0, 1) * 12) / 12
    return X, y


@pytest.mark.parametrize("n", [2, 5, 12, 30])
@pytest.mark.parametrize("kind", ["random", "duplicates", "constant", "plateaus"])
def test_gp_matches_sklearn(kind, n):
    X, y = _points(kind, n, seed=n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = _sklearn_gp().fit(X, y)
        gp = tbo.GaussianProcess(alpha=1e-6, n_restarts=2, random_state=0).fit(X, y)
    want_ls = ref.kernel_.length_scale
    assert abs(gp.length_scale - want_ls) <= 1e-6 * want_ls, (gp.length_scale, want_ls)
    cand = np.random.RandomState(n).uniform(0.4, 1.1, size=(512, 1))
    mu, sd = gp.predict(cand)
    mu_ref, sd_ref = ref.predict(cand, return_std=True)
    np.testing.assert_allclose(mu, mu_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(sd, sd_ref, rtol=0, atol=1e-8)


@pytest.mark.parametrize("length_scale", [1e-3, 0.1, 1.0, 40.0])
def test_matern52_matches_sklearn(length_scale):
    X = np.random.default_rng(3).uniform(0, 2, size=(9, 1))
    Y = np.random.default_rng(4).uniform(0, 2, size=(5, 1))
    kern = Matern(length_scale=length_scale, nu=2.5)
    K, grad = tbo.matern52(X, length_scale=length_scale, eval_gradient=True)
    K_ref, grad_ref = kern(X, eval_gradient=True)
    assert np.array_equal(K, K_ref) and np.array_equal(grad, grad_ref)
    assert np.array_equal(tbo.matern52(X, Y, length_scale), kern(X, Y))


def _objective(x):
    return float(np.round(np.clip(1.5 - 3 * abs(x - 0.83), 0, 1) * 20) / 20
                 + 0.01 * np.sin(40 * x))


@pytest.mark.parametrize("init,n_iter", [(5, 10), (10, 20)])
def test_bayesian_optimization_matches_jax(init, n_iter):
    runs = []
    for mod in (jbo, tbo):
        opt = mod.BayesianOptimization(f=lambda q: _objective(q), pbounds={"q": (0.5, 1.0)},
                                       random_state=0, verbose=0)
        opt.maximize(init_points=init, n_iter=n_iter)
        runs.append(opt)
    want, got = runs
    assert len(got.X) == len(want.X) == init + n_iter
    np.testing.assert_allclose(np.stack(got.X), np.stack(want.X), rtol=0, atol=1e-12)
    assert got.y == want.y
    assert abs(got.max["params"]["q"] - want.max["params"]["q"]) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmentation_optimize_threshold_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    targets = np.zeros(n, dtype=np.int64)
    targets[np.cumsum(rng.integers(60, 140, size=60))[:-1] % n] = 1
    scores = np.convolve(targets.astype(float), np.hanning(15), "same") + 0.3 * rng.random(n)
    est = n / max(targets.sum(), 1)
    got = tseg.optimize_threshold(scores, targets, est)
    want = jseg.optimize_threshold(scores, targets, est)
    assert 0.5 * est <= got <= 1.25 * est and abs(got - want) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anomaly_optimize_threshold_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    labels = np.zeros(n, dtype=np.int64)
    for s in rng.integers(0, n - 40, size=8):
        labels[s:s + rng.integers(5, 40)] = 1
    scores = rng.gamma(2.0, 1.0, n) + 3.0 * labels * rng.random(n)
    got, want = tad.optimize_threshold(scores, labels), jad.optimize_threshold(scores, labels)
    assert 0.5 <= got <= 1.0 and abs(got - want) <= 1e-12


@pytest.mark.parametrize("case", ["seg-boundary", "seg-steps"])
def test_segmentation_optimize_chain_matches_jax(case):
    cfg = _cfg(case, **{"tasks.segmentation.distance_thresh": "optimize"})
    for split in ("val", "test"):
        jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
        out = _window_outputs(case, td, 11)
        jt, tt = _bare(jseg.SegmentationTask, cfg, None, out), _bare(
            tseg.SegmentationTask, cfg, None, out)
        rj, rt = jt.predict(JaxBatchPipeline(jd, 4)), tt.predict(BatchPipeline(td, 4))
        assert set(rt) == set(rj)
        for k in rj:
            _equal(rt[k], rj[k], k)
        assert tt.score(rt) == jt.score(rj)


@pytest.mark.parametrize("thresh", ["optimize", "optimize-test"])
@pytest.mark.parametrize("split", ["val", "test"])
def test_anomaly_optimize_chain_matches_jax(split, thresh):
    cfg = _cfg("anomaly", **{"tasks.anomaly_detection.threshold": thresh})
    jd, td = jax_get_dataset(cfg, split), SyntheticDataset(cfg, split)
    out = _window_outputs("anomaly", td, 5)
    jt = _bare(jad.AnomalyDetectionTask, cfg, jax_get_dataset(cfg, "train"), out)
    tt = _bare(tad.AnomalyDetectionTask, cfg, SyntheticDataset(cfg, "train"), out)
    rj = jt.predict(JaxBatchPipeline(jd, 4), split=split)
    rt = tt.predict(BatchPipeline(td, 4), split)
    assert set(rt) == set(rj.to_dict())
    for k in rt:
        _equal(rt[k], rj[k], k)
    auto = 1 - rt["anomaly_labels"].sum() / (len(rt["anomaly_labels"])
                                             + tt.train_dataset.n_points)
    assert (rt["anomaly_quantile"] == auto) == (thresh == "optimize-test" and split == "val")
    sj = jt.score_anomalies(rj.anomaly_preds, rj.anomaly_labels, scores=rj.anomaly_scores)
    st_ = tt.score_anomalies(rt["anomaly_preds"], rt["anomaly_labels"],
                             scores=rt["anomaly_scores"])
    for k in sj:
        assert abs(st_[k] - sj[k]) <= (1e-12 if k == "auroc" else 0), k
