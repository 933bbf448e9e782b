"""Isotropic Matern kernels (nu = 1/2, 3/2, 5/2), the JAX package's
``kernels/matern.py``.

With r = |x_i - x_j| and length-scale ``sigma`` (the RBF's convention):

    nu = 1/2:  k = exp(-r / sigma)
    nu = 3/2:  k = (1 + a) exp(-a),            a = sqrt(3) r / sigma
    nu = 5/2:  k = (1 + a + a^2 / 3) exp(-a),  a = sqrt(5) r / sigma

``r`` is ``sqrt(max(r^2, 1e-24))``: the floor keeps the derivative finite
on the pinned zero diagonal and moves k by under 1e-12 there.  The map is
one definition (``ops/streamed_matvec.matern_tile``) shared by ``gram``,
``gram_from_cache`` (over the cached squared distances), ``cross`` and the
matfree lane's streamed tiles.  The ARD variants are not
ported yet (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

from spark_gp_tpu_torch.kernels.base import ScalarLengthscaleHypers
from spark_gp_tpu_torch.ops.distance import sq_dist, sq_dist_self
from spark_gp_tpu_torch.ops.streamed_matvec import matern_tile, streamed_matvec


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


class Matern12Kernel(_MaternIso):
    """Exponential / Ornstein-Uhlenbeck kernel (Matern nu = 1/2)."""

    _nu2 = 1


class Matern32Kernel(_MaternIso):
    """Matern nu = 3/2: once-differentiable sample paths."""

    _nu2 = 3


class Matern52Kernel(_MaternIso):
    """Matern nu = 5/2: twice-differentiable sample paths."""

    _nu2 = 5
