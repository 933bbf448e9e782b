"""Matern kernels (nu = 1/2, 3/2, 5/2 isotropic; 3/2 and 5/2 ARD), the JAX
package's ``kernels/matern.py``.

With r = |x_i - x_j| and length-scale ``sigma`` (the RBF's convention):

    nu = 1/2:  k = exp(-r / sigma)
    nu = 3/2:  k = (1 + a) exp(-a),            a = sqrt(3) r / sigma
    nu = 5/2:  k = (1 + a + a^2 / 3) exp(-a),  a = sqrt(5) r / sigma

``r`` is ``sqrt(max(r^2, 1e-24))``: the floor keeps the derivative finite
on the pinned zero diagonal and moves k by under 1e-12 there.  The map is
one definition (``ops/streamed_matvec.matern_tile``) shared by ``gram``,
``gram_from_cache`` (over the cached squared distances), ``cross`` and the
matfree lane's streamed tiles.

The ARD variants weigh each feature by a trainable inverse length-scale
(``r^2 = |(x_i - x_j) * beta|^2``, the ARD-RBF's convention) and take the
same floored ``sqrt``; like the ARD-RBF they have neither a gram cache nor
a streaming form.
"""

from __future__ import annotations

import math

import numpy as np

from spark_gp_tpu_torch.kernels.base import ARDHypers, ScalarLengthscaleHypers
from spark_gp_tpu_torch.ops.distance import (
    sq_dist,
    sq_dist_self,
    weighted_sq_dist,
    weighted_sq_dist_self,
)
from spark_gp_tpu_torch.ops.streamed_matvec import (
    matern_of_a,
    matern_tile,
    safe_r,
    streamed_matvec,
)


class _MaternIso(ScalarLengthscaleHypers):
    """One trainable length-scale ``sigma`` in ``[lower, upper]``."""

    _nu2: int  # 2 * nu, set by subclasses

    def gram(self, theta, x):
        return matern_tile(self._nu2, theta, sq_dist_self(x))

    def prepare(self, x):
        # sigma acts only through the elementwise map: the squared
        # distances are the theta-invariant cache
        return sq_dist_self(x)

    def gram_from_cache(self, theta, cache):
        return matern_tile(self._nu2, theta, cache)

    def cross(self, theta, x_test, x_train):
        return matern_tile(self._nu2, theta, sq_dist(x_test, x_train))

    def prepare_matvec(self, x):
        return x

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, f"matern{self._nu2}2", theta)

    def describe(self, theta) -> str:
        return f"Matern{self._nu2}2Kernel(sigma={float(np.asarray(theta)[0]):.1e})"


class Matern12Kernel(_MaternIso):
    """Exponential / Ornstein-Uhlenbeck kernel (Matern nu = 1/2)."""

    _nu2 = 1


class Matern32Kernel(_MaternIso):
    """Matern nu = 3/2: once-differentiable sample paths."""

    _nu2 = 3


class Matern52Kernel(_MaternIso):
    """Matern nu = 5/2: twice-differentiable sample paths."""

    _nu2 = 5


class _MaternARD(ARDHypers):
    """Per-feature inverse length-scales ``beta`` (``theta = beta``)."""

    _nu2: int

    def _of_sqd(self, sqd):
        return matern_of_a(self._nu2, math.sqrt(self._nu2) * safe_r(sqd))

    def gram(self, theta, x):
        return self._of_sqd(weighted_sq_dist_self(x, theta))

    def cross(self, theta, x_test, x_train):
        return self._of_sqd(weighted_sq_dist(x_test, x_train, theta))

    def describe(self, theta) -> str:
        vals = ", ".join(f"{v:.1e}" for v in np.asarray(theta))
        return f"ARDMatern{self._nu2}2Kernel(beta=[{vals}])"


class ARDMatern32Kernel(_MaternARD):
    """ARD Matern nu = 3/2."""

    _nu2 = 3


class ARDMatern52Kernel(_MaternARD):
    """ARD Matern nu = 5/2."""

    _nu2 = 5
