"""Minimal Bayesian optimization (Gaussian process + expected improvement)
(counterpart: pssr2_tpu/bayes.py, of which this module is a copy: the port
imports nothing of the JAX package, and this one is pure numpy and scipy).

Stands in for skopt's ``gp_minimize``/``Real``/``Integer``, which the
reference uses to fit crappifier parameters (reference: pssr/train.py:324-346)
and which is not in this framework's environment.  The objective is cheap
relative to GP cost here (dozens of calls), so a dense-Cholesky GP with
random-candidate EI maximization is plenty.
"""

import numpy as np
from scipy.linalg import cho_factor, cho_solve


class Dimension:
    pass


class Real(Dimension):
    def __init__(self, low, high, name=None):
        assert high > low
        self.low, self.high, self.name = float(low), float(high), name

    def sample(self, rng, n):
        return rng.uniform(self.low, self.high, n)

    def clip(self, x):
        return float(np.clip(x, self.low, self.high))


class Integer(Dimension):
    def __init__(self, low, high, name=None):
        assert high > low
        self.low, self.high, self.name = int(low), int(high), name

    def sample(self, rng, n):
        return rng.integers(self.low, self.high + 1, n).astype(float)

    def clip(self, x):
        return int(np.clip(round(x), self.low, self.high))


class OptimizeResult:
    def __init__(self, x, fun, x_iters, func_vals):
        self.x = x
        self.fun = fun
        self.x_iters = x_iters
        self.func_vals = np.asarray(func_vals)

    def __repr__(self):
        return f"OptimizeResult(x={self.x}, fun={self.fun})"


def _normalize(X, space):
    lows = np.array([d.low for d in space])
    highs = np.array([d.high for d in space])
    return (X - lows) / (highs - lows)


def _rbf(a, b, length=0.25):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / length**2)


def gp_minimize(
    func,
    dimensions,
    n_calls: int = 100,
    n_initial_points: int = 10,
    random_state=None,
    noise: float = 1e-2,
    **_ignored,
):
    """Minimize ``func`` over ``dimensions`` (list of Real/Integer).

    ``noise`` is the assumed observation-noise variance on the normalized
    objective scale (skopt models this with a WhiteKernel).  Crappifier
    objectives are stochastic (fresh noise draws per call), and a
    noiseless GP interpolating noisy values produces erratic EI — the
    parameter-recovery oracle (the JAX package's tests/test_bayes.py) fails without it.

    Returns an object with ``.x`` (best params), ``.fun`` (best value),
    ``.x_iters`` and ``.func_vals`` (skopt-compatible surface).
    """
    rng = np.random.default_rng(random_state)
    space = list(dimensions)
    n_initial_points = min(n_initial_points, n_calls)

    X, y = [], []

    def _typed(point):
        return [d.clip(v) for d, v in zip(space, point)]

    # initial random exploration
    init = np.stack([d.sample(rng, n_initial_points) for d in space], axis=1)
    for row in init:
        point = _typed(row)
        X.append([float(v) for v in point])
        y.append(float(func(point)))

    for _ in range(n_calls - n_initial_points):
        Xn = _normalize(np.asarray(X), space)
        ya = np.asarray(y)
        y_mean, y_std = ya.mean(), ya.std() + 1e-12
        yn = (ya - y_mean) / y_std

        K = _rbf(Xn, Xn) + (1e-6 + noise) * np.eye(len(Xn))
        try:
            chol = cho_factor(K, lower=True)
            alpha = cho_solve(chol, yn)
        except np.linalg.LinAlgError:
            # degenerate kernel: fall back to random sampling this step
            point = _typed([d.sample(rng, 1)[0] for d in space])
            X.append([float(v) for v in point])
            y.append(float(func(point)))
            continue

        # candidate pool: random + jittered best
        n_cand = 512
        cand = np.stack([d.sample(rng, n_cand) for d in space], axis=1)
        best_row = np.asarray(X[int(np.argmin(ya))])
        scales = np.array([(d.high - d.low) * 0.1 for d in space])
        local = best_row + rng.normal(0, 1, (64, len(space))) * scales
        cand = np.vstack([cand, local])
        cand_n = _normalize(cand, space)

        Ks = _rbf(cand_n, Xn)
        mu = Ks @ alpha
        v = cho_solve(chol, Ks.T)
        var = np.maximum(1.0 - np.sum(Ks * v.T, axis=1), 1e-12)
        sigma = np.sqrt(var)

        # expected improvement (minimization)
        from scipy.stats import norm as _norm

        best = yn.min()
        z = (best - mu) / sigma
        ei = sigma * (z * _norm.cdf(z) + _norm.pdf(z))

        point = _typed(cand[int(np.argmax(ei))])
        X.append([float(v) for v in point])
        y.append(float(func(point)))

    best_idx = int(np.argmin(y))
    best_x = _typed(X[best_idx])
    return OptimizeResult(best_x, y[best_idx], [list(row) for row in X], y)
