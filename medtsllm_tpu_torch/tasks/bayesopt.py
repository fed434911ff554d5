"""Bayesian optimisation of a threshold (port of
``medtsllm_tpu/tasks/bayesopt.py``): a Gaussian process with a Matern 5/2
kernel over the points seen, then the upper confidence bound (kappa
2.576) over 512 seeded candidates.

The JAX package fits scikit-learn's ``GaussianProcessRegressor(
kernel=Matern(nu=2.5), alpha=1e-6, normalize_y=True,
n_restarts_optimizer=2, random_state=0)``; the card's machine has no
scikit-learn, so ``GaussianProcess`` computes the same in numpy and scipy,
in the same order of operations: every fit starts from length scale 1,
searches the log length scale in log(1e-5, 1e5) by L-BFGS-B on the
negative log-marginal likelihood and its analytic gradient, then from two
starts drawn uniformly in the log bounds by a ``RandomState`` made anew
from the seed, and keeps the best; the targets are z-scored and the
posterior mean and standard deviation scaled back
(tests/test_torch_bayesopt.py holds it against scikit-learn)."""

from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.optimize
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.spatial.distance import cdist, pdist, squareform

_SQRT5 = math.sqrt(5)


def matern52(X: np.ndarray, Y: np.ndarray | None = None, length_scale: float = 1.0,
             eval_gradient: bool = False):
    """k(X, Y) of the isotropic Matern 5/2 kernel (k(X, X) with a unit
    diagonal when ``Y`` is None) and, with ``eval_gradient``, its gradient
    in log(length_scale), [n, n, 1]."""
    if Y is None:
        dists = pdist(X / length_scale, metric="euclidean")
    else:
        dists = cdist(X / length_scale, Y / length_scale, metric="euclidean")
    K = dists * _SQRT5
    K = (1.0 + K + K ** 2 / 3.0) * np.exp(-K)
    if Y is None:
        K = squareform(K)
        np.fill_diagonal(K, 1)
    if not eval_gradient:
        return K
    D = squareform(dists ** 2)[:, :, np.newaxis]
    tmp = np.sqrt(5 * D.sum(-1))[..., np.newaxis]
    grad = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
    return K, grad.sum(-1)[:, :, np.newaxis]


class GaussianProcess:
    """Regression with a Matern 5/2 kernel, ``alpha`` added to the
    diagonal, z-scored targets and the length scale fitted by maximum
    likelihood with ``n_restarts`` extra starts."""

    BOUNDS = np.log(np.array([[1e-5, 1e5]]))

    def __init__(self, alpha: float = 1e-6, n_restarts: int = 2, random_state: int = 0):
        self.alpha = alpha
        self.n_restarts = n_restarts
        self.random_state = random_state

    def _lml(self, theta: np.ndarray):
        """(negative log-marginal likelihood, its gradient) at theta =
        log(length_scale)."""
        K, K_grad = matern52(self.X_train, length_scale=np.exp(theta[0]), eval_gradient=True)
        K[np.diag_indices_from(K)] += self.alpha
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return np.inf, np.zeros_like(theta)
        y = self.y_train[:, np.newaxis]
        alpha = cho_solve((L, True), y, check_finite=False)
        lml = -0.5 * np.einsum("ik,ik->k", y, alpha)
        lml -= np.log(np.diag(L)).sum()
        lml -= K.shape[0] / 2 * np.log(2 * np.pi)
        inner = np.einsum("ik,jk->ijk", alpha, alpha)
        inner -= cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)[..., np.newaxis]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner, K_grad)
        return -lml.sum(axis=-1), -grad.sum(axis=-1)

    def _minimize(self, theta0: np.ndarray):
        res = scipy.optimize.minimize(self._lml, theta0, method="L-BFGS-B", jac=True,
                                      bounds=self.BOUNDS)
        return res.x, res.fun

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.RandomState(self.random_state)
        self.y_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self.y_std = 1.0 if std == 0.0 else std
        self.X_train, self.y_train = X, (y - self.y_mean) / self.y_std
        optima = [self._minimize(np.zeros(1))]  # length scale 1
        for _ in range(self.n_restarts):
            optima.append(self._minimize(rng.uniform(self.BOUNDS[:, 0], self.BOUNDS[:, 1])))
        self.theta = optima[int(np.argmin([f for _, f in optima]))][0]
        K = matern52(X, length_scale=self.length_scale)
        K[np.diag_indices_from(K)] += self.alpha
        self.L = cholesky(K, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.L, True), self.y_train, check_finite=False)
        return self

    @property
    def length_scale(self) -> float:
        return float(np.exp(self.theta[0]))

    def predict(self, X: np.ndarray):
        """The posterior mean and standard deviation at ``X``."""
        K_trans = matern52(np.asarray(X, dtype=np.float64), self.X_train, self.length_scale)
        mean = self.y_std * (K_trans @ self.alpha_) + self.y_mean
        V = solve_triangular(self.L, K_trans.T, lower=True, check_finite=False)
        var = np.ones(K_trans.shape[0]) - np.einsum("ij,ji->i", V.T, V)
        var[var < 0] = 0.0
        var = np.outer(var, self.y_std ** 2).reshape(*var.shape, -1)[:, 0]
        return mean, np.sqrt(var)


class BayesianOptimization:
    """Maximise ``f`` over the box ``pbounds`` ({name: (low, high)}, the
    names in sorted order): ``init_points`` uniform draws, then
    ``n_iter`` points each maximising the UCB of the process fitted to the
    points so far; the draws from one ``RandomState(random_state)``."""

    def __init__(self, f, pbounds: dict, random_state: int = 0, verbose: int = 0,
                 allow_duplicate_points: bool = True):
        self.f = f
        self.keys = sorted(pbounds.keys())
        self.bounds = np.array([pbounds[k] for k in self.keys], dtype=float)
        self.rng = np.random.RandomState(random_state)
        self.X: list[np.ndarray] = []
        self.y: list[float] = []
        self._gp = GaussianProcess(alpha=1e-6, n_restarts=2, random_state=random_state)

    def _sample(self, n: int) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + (hi - lo) * self.rng.uniform(size=(n, len(self.keys)))

    def _evaluate(self, x: np.ndarray) -> float:
        val = float(self.f(**dict(zip(self.keys, x))))
        self.X.append(np.asarray(x, dtype=float))
        self.y.append(val)
        return val

    def _suggest(self, kappa: float = 2.576, n_candidates: int = 512) -> np.ndarray:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._gp.fit(np.stack(self.X), np.asarray(self.y))
        cand = self._sample(n_candidates)
        mu, sigma = self._gp.predict(cand)
        return cand[int(np.argmax(mu + kappa * sigma))]

    def maximize(self, init_points: int = 5, n_iter: int = 25) -> None:
        for x in self._sample(init_points):
            self._evaluate(x)
        for _ in range(n_iter):
            self._evaluate(self._suggest())

    @property
    def max(self) -> dict:
        i = int(np.argmax(self.y))
        return {"target": self.y[i], "params": dict(zip(self.keys, self.X[i]))}
