"""Rational-quadratic, dot-product and polynomial kernels, the JAX
package's ``kernels/families.py``.

* :class:`RationalQuadraticKernel` --
  ``k = (1 + r^2 / (2 alpha sigma^2))^(-alpha)``, ``theta = [sigma, alpha]``;
* :class:`DotProductKernel` -- ``k = sigma0^2 + <x, x'>``,
  ``theta = [sigma0]``;
* :class:`PolynomialKernel` -- ``k = (<x, x'> + c)^degree`` with a static
  integer degree, ``theta = [c]``.

Each map is one definition in ``ops/streamed_matvec.py``, shared by
``gram``, ``gram_from_cache`` (over the cached squared distances or inner
products), ``cross`` and the matfree lane's streamed tiles.  The ARD
rational quadratic, the periodic and the spectral-mixture kernels are not
ported yet (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, StationaryKernel
from spark_gp_tpu_torch.ops.distance import sq_dist, sq_dist_self
from spark_gp_tpu_torch.ops.streamed_matvec import (
    dot_tile,
    poly_tile,
    rq_tile,
    streamed_matvec,
)


def _pair(value, default: float) -> tuple:
    """Broadcast a scalar-or-length-2 bound spec to a (v0, v1) tuple."""
    arr = np.broadcast_to(
        np.asarray(default if value is None else value, dtype=np.float64), (2,)
    )
    return (float(arr[0]), float(arr[1]))


class RationalQuadraticKernel(StationaryKernel):
    """Rational quadratic: ``k = (1 + r^2 / (2 alpha sigma^2))^(-alpha)``.

    ``theta = [sigma, alpha]``, trainable in ``[1e-6, inf)`` by default;
    ``lower`` / ``upper`` take a scalar or one bound per hyperparameter.
    """

    n_hypers = 2

    def __init__(self, sigma: float = 1.0, alpha: float = 1.0,
                 lower=None, upper=None):
        self.theta0_ = (float(sigma), float(alpha))
        self.lower_ = _pair(lower, 1e-6)
        self.upper_ = _pair(upper, math.inf)

    def init_theta(self):
        return np.array(self.theta0_, dtype=np.float64)

    def bounds(self):
        return (
            np.array(self.lower_, dtype=np.float64),
            np.array(self.upper_, dtype=np.float64),
        )

    def gram(self, theta, x):
        return rq_tile(theta, sq_dist_self(x))

    def prepare(self, x):
        # sigma and alpha both act through the elementwise map
        return sq_dist_self(x)

    def gram_from_cache(self, theta, cache):
        return rq_tile(theta, cache)

    def cross(self, theta, x_test, x_train):
        return rq_tile(theta, sq_dist(x_test, x_train))

    def prepare_matvec(self, x):
        return x

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, "rq", theta)


class _OneHyper(Kernel):
    """One trainable hyperparameter ``h`` in ``[lower, upper]``."""

    n_hypers = 1

    def __init__(self, h: float, lower: float, upper: float):
        self.h0 = float(h)
        self.lower = float(lower)
        self.upper = float(upper)

    def init_theta(self):
        return np.array([self.h0], dtype=np.float64)

    def bounds(self):
        return (
            np.array([self.lower], dtype=np.float64),
            np.array([self.upper], dtype=np.float64),
        )

    def self_diag(self, theta, x):
        return self.diag(theta, x)

    def prepare(self, x):
        # the inner products are the theta-invariant cache; the
        # hyperparameter acts elementwise on them
        return x @ x.mT

    def prepare_matvec(self, x):
        return x


class DotProductKernel(_OneHyper):
    """Linear kernel ``k(x, x') = sigma0^2 + <x, x'>`` (non-stationary);
    ``theta = [sigma0]``, trainable in ``[0, inf)`` by default."""

    def __init__(self, sigma0: float = 1.0, lower: float = 0.0,
                 upper: float = math.inf):
        super().__init__(sigma0, lower, upper)

    def gram(self, theta, x):
        return dot_tile(theta, x @ x.mT)

    def gram_from_cache(self, theta, cache):
        return dot_tile(theta, cache)

    def cross(self, theta, x_test, x_train):
        return dot_tile(theta, x_test @ x_train.mT)

    def diag(self, theta, x):
        return dot_tile(theta, torch.sum(x * x, dim=-1))

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, "dot", theta)


class PolynomialKernel(_OneHyper):
    """Polynomial kernel ``k(x, x') = (<x, x'> + c)^degree`` with a static
    positive integer ``degree``; ``theta = [c]``, trainable in
    ``[0, inf)`` by default."""

    def __init__(self, degree: int = 2, c: float = 1.0, lower: float = 0.0,
                 upper: float = math.inf):
        degree = int(degree)
        if degree < 1:
            raise ValueError("degree must be a positive integer")
        self.degree = degree
        super().__init__(c, lower, upper)

    def gram(self, theta, x):
        return poly_tile(theta, x @ x.mT, self.degree)

    def gram_from_cache(self, theta, cache):
        return poly_tile(theta, cache, self.degree)

    def cross(self, theta, x_test, x_train):
        return poly_tile(theta, x_test @ x_train.mT, self.degree)

    def diag(self, theta, x):
        return poly_tile(theta, torch.sum(x * x, dim=-1), self.degree)

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, "poly", theta, self.degree)
