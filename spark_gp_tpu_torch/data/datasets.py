"""Datasets of the reference's examples and the stress configs.

* :func:`make_synthetics` -- 2000-point ``sin(x) + N(0, 0.01)`` on [0, 1].
* :func:`load_airfoil` -- UCI airfoil self-noise, 1503 rows x 5 features
  (``files/airfoil.csv``, a copy of the JAX package's file).
* :func:`load_protein` -- UCI CASP protein, 45730 rows x 9 features: the
  CSV at ``path`` when given, else a synthetic stand-in of the same shape
  (the same generator and seed as the JAX package's stand-in).
* :func:`load_year_msd` -- Year-Prediction-MSD, 515345 rows x 90
  features: likewise (the stand-in's signal on 8 of the 90 features).
* :func:`load_iris` -- UCI iris, 150 rows x 4 features, 3 classes
  (``files/iris.csv``, a copy of the JAX package's file).
* :func:`load_mnist_binary` -- MNIST 6-vs-8: a label-first CSV at ``path``
  when given, else the JAX package's seeded 784-d stand-in, row for row.
"""

from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "files")

#: additive noise level of the regression stand-ins
STANDIN_NOISE = 0.1
#: (features, seed, effective_dim) of each regression stand-in, the JAX
#: package's ``_STANDIN_PARAMS``
_STANDIN_PARAMS = {
    "protein": (9, 7, None),
    "year_msd": (90, 11, 8),
}


def make_synthetics(n: int = 2000, noise_var: float = 0.01, seed: int = 13):
    x = np.linspace(0.0, 1.0, n).reshape(n, 1)
    rng = np.random.default_rng(seed)
    y = np.sin(x[:, 0]) + rng.normal(0.0, np.sqrt(noise_var), size=n)
    return x, y


def load_airfoil(path: str | None = None):
    """``(x [1503, 5], y [1503])``: frequency, angle of attack, chord length,
    free-stream velocity, displacement thickness -> sound pressure."""
    raw = np.loadtxt(
        path or os.path.join(_DATA_DIR, "airfoil.csv"), delimiter=",", ndmin=2
    )
    return raw[:, :5], raw[:, 5]


def _synthetic_regression(n: int, p: int, seed: int,
                          noise: float = STANDIN_NOISE, effective_dim=None):
    """``y = sin(w1.x) + 0.5 cos(3 w2.x) + 0.1 (w1.x)^2 + noise``, the
    signal on the first ``effective_dim`` features (all when None), the
    rest distractors."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    k = p if effective_dim is None else min(effective_dim, p)
    w1 = np.zeros(p)
    w2 = np.zeros(p)
    w1[:k] = rng.normal(size=k) / np.sqrt(k)
    w2[:k] = rng.normal(size=k) / np.sqrt(k)
    y = (
        np.sin(x @ w1)
        + 0.5 * np.cos(3.0 * (x @ w2))
        + 0.1 * (x @ w1) ** 2
        + noise * rng.normal(size=n)
    )
    return x, y


def load_iris(path: str | None = None):
    """``(x [150, 4], y [150] in {0, 1, 2})`` with the reference's class
    indices: versicolor 0, setosa 1, virginica 2."""
    name2idx = {"Iris-versicolor": 0, "Iris-setosa": 1, "Iris-virginica": 2}
    xs, ys = [], []
    with open(path or os.path.join(_DATA_DIR, "iris.csv")) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            *feats, name = line.split(",")
            xs.append([float(v) for v in feats])
            ys.append(name2idx[name])
    return np.asarray(xs), np.asarray(ys, dtype=np.float64)


#: planted Bayes accuracy of the MNIST stand-in: two unit-covariance
#: Gaussians whose centers lie d apart have Bayes accuracy Phi(d / 2)
MNIST_STANDIN_BAYES_ACCURACY = 0.970
_MNIST_STANDIN_SEPARATION = 3.76  # 2 * Phi^-1(0.970)


def load_mnist_binary(path: str | None = None, digits=(6, 8), seed: int = 0):
    """MNIST ``digits[0]``-vs-``digits[1]`` as ``(x [n, 784], y in {0, 1})``:
    the rows of those digits in a label-first CSV at ``path``, else a
    seeded stand-in of the same width -- 1000 points a class around two
    centers ``MNIST_STANDIN_BAYES_ACCURACY`` apart in Bayes accuracy,
    shuffled -- the JAX package's stand-in, row for row."""
    if path is not None:
        raw = np.loadtxt(
            path, delimiter=",", skiprows=1 if _has_header(path) else 0, ndmin=2
        )
        labels = raw[:, 0]
        keep = np.isin(labels, digits)
        return raw[keep, 1:], (labels[keep] == digits[1]).astype(np.float64)
    rng = np.random.default_rng(seed)
    n_per = 1000
    direction = rng.normal(size=784)
    direction *= (_MNIST_STANDIN_SEPARATION / 2.0) / np.linalg.norm(direction)
    centers = np.stack([-direction, direction])
    x = np.concatenate([centers[i] + rng.normal(size=(n_per, 784)) for i in range(2)])
    y = np.concatenate([np.zeros(n_per), np.ones(n_per)])
    perm = rng.permutation(2 * n_per)
    return x[perm], y[perm]


def _has_header(path: str) -> bool:
    with open(path) as fh:
        first = fh.readline().split(",")[0].strip()
    try:
        float(first)
        return False
    except ValueError:
        return True


def _target_first_csv(path: str, n, seed: int):
    """``(x, y)`` of a CSV whose first column is the target; ``n``
    subsamples it (rows kept in order)."""
    raw = np.loadtxt(
        path, delimiter=",", skiprows=1 if _has_header(path) else 0, ndmin=2
    )
    x, y = raw[:, 1:], raw[:, 0]
    if n is None or n >= x.shape[0]:
        return x, y
    idx = np.sort(np.random.default_rng(seed).choice(x.shape[0], size=n, replace=False))
    return x[idx], y[idx]


def load_protein(path: str | None = None, n: int | None = None,
                 seed: int = _STANDIN_PARAMS["protein"][1]):
    """UCI CASP (``RMSD,F1..F9``): ``(x [N, 9], y [N])``.  ``n`` subsamples
    the CSV (rows kept in order) or sizes the stand-in."""
    if path is not None:
        return _target_first_csv(path, n, seed)
    p, _, eff = _STANDIN_PARAMS["protein"]
    return _synthetic_regression(n or 45730, p, seed, effective_dim=eff)


def load_year_msd(path: str | None = None, n: int | None = None,
                  seed: int = _STANDIN_PARAMS["year_msd"][1]):
    """Year-Prediction-MSD (``year,F1..F90``): ``(x [N, 90], y [N])``.
    ``n`` subsamples the CSV (rows kept in order) or sizes the stand-in,
    the JAX package's: 515,345 rows by default, the signal on the first
    8 of the 90 features."""
    if path is not None:
        return _target_first_csv(path, n, seed)
    p, _, eff = _STANDIN_PARAMS["year_msd"]
    return _synthetic_regression(n or 515345, p, seed, effective_dim=eff)


#: planted additive noise of the clustered stand-in, the calibrated side
#: of the aggregation bars (:func:`clustered_noise_floor`)
CLUSTERED_NOISE = 0.05

#: noise ramp endpoints of the heteroscedastic stand-in: sigma(t) runs
#: linearly from LOW to HIGH across the input range
HETERO_NOISE_LOW = 0.02
HETERO_NOISE_HIGH = 0.40


def make_clustered(n: int = 4096, p: int = 2, n_clusters: int = 8, seed: int = 3,
                   noise: float = CLUSTERED_NOISE, spread: float = 0.15):
    """Disjoint-cluster regression, the aggregation plane's canary:
    ``n_clusters`` well-separated Gaussian blobs, each with its own local
    response (a sinusoid plus an offset) and the planted noise.  Far from
    its own cluster every expert reverts to the prior, so the plain
    product of experts is overconfident there by construction.  Row ``i``
    belongs to cluster ``i % n_clusters``, so round-robin grouping pins
    every expert to one cluster whenever ``n_clusters`` divides ``E``.
    Returns ``(x [n, p], y [n])``, the JAX package's values."""
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.normal(size=(n_clusters, p))
    assign = np.arange(n) % n_clusters
    x = centers[assign] + spread * rng.normal(size=(n, p))
    w = rng.normal(size=(n_clusters, p))
    offsets = 2.0 * rng.normal(size=n_clusters)
    y = (
        np.sin(np.einsum("np,np->n", x - centers[assign], w[assign]) * 3.0)
        + offsets[assign]
        + noise * rng.normal(size=n)
    )
    return x, y


def clustered_noise_floor(n: int = 4096) -> float:
    """Irreducible scaled RMSE of :func:`make_clustered`: the planted noise
    over the target's standard deviation."""
    _, y = make_clustered(n)
    return CLUSTERED_NOISE / float(np.std(y))


def make_heteroscedastic(n: int = 4096, seed: int = 5):
    """1-d regression with input-dependent noise, the calibration canary:
    ``y = sin(6 t) + sigma(t) eps`` with ``sigma`` ramping linearly from
    :data:`HETERO_NOISE_LOW` to :data:`HETERO_NOISE_HIGH` over ``t in
    [0, 1]``.  Returns ``(x [n, 1], y [n], sigma [n])``."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(size=n))
    sigma = HETERO_NOISE_LOW + (HETERO_NOISE_HIGH - HETERO_NOISE_LOW) * t
    y = np.sin(6.0 * t) + sigma * rng.normal(size=n)
    return t[:, None], y, sigma
