"""RBF and ARD-RBF kernels: one matmul for the distances (``ops/distance.py``)
followed by an elementwise ``exp``.  Hyperparameter derivatives come from
autograd.  The RBF map is one definition (``ops/streamed_matvec.rbf_tile``)
shared by ``gram``, ``gram_from_cache``, ``cross`` and the matfree lane's
streamed tiles.  The ARD metric weighs the distances by theta, so it has
neither a gram cache (``prepare`` stays None) nor a streaming form."""

from __future__ import annotations

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import ARDHypers, ScalarLengthscaleHypers
from spark_gp_tpu_torch.ops.distance import (
    sq_dist,
    sq_dist_self,
    weighted_sq_dist,
    weighted_sq_dist_self,
)
from spark_gp_tpu_torch.ops.streamed_matvec import rbf_tile, streamed_matvec


class RBFKernel(ScalarLengthscaleHypers):
    """``k(x_i, x_j) = exp(-|x_i - x_j|^2 / (2 sigma^2))`` with one trainable
    length-scale ``sigma`` bounded in ``[lower, upper]``."""

    def gram(self, theta, x):
        return rbf_tile(theta, sq_dist_self(x))

    def prepare(self, x):
        # the theta-invariant squared-distance block, pinned diagonal
        return sq_dist_self(x)

    def gram_from_cache(self, theta, cache):
        return rbf_tile(theta, cache)

    def cross(self, theta, x_test, x_train):
        return rbf_tile(theta, sq_dist(x_test, x_train))

    def prepare_matvec(self, x):
        return x

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, "rbf", theta)

    def describe(self, theta) -> str:
        return f"RBFKernel(sigma={float(np.asarray(theta)[0]):.1e})"


class ARDRBFKernel(ARDHypers):
    """Automatic Relevance Determination RBF:
    ``k(x_i, x_j) = exp(-|(x_i - x_j) * beta|^2)`` with one trainable inverse
    length-scale per feature (no factor 1/2, beta multiplies -- the JAX
    package's convention, so hyperparameter values compare directly)."""

    def gram(self, theta, x):
        return torch.exp(-weighted_sq_dist_self(x, theta))

    def cross(self, theta, x_test, x_train):
        return torch.exp(-weighted_sq_dist(x_test, x_train, theta))

    def describe(self, theta) -> str:
        vals = ", ".join(f"{v:.1e}" for v in np.asarray(theta))
        return f"ARDRBFKernel(beta=[{vals}])"
