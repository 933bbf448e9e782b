"""The other kernel families of the JAX package's ``kernels/families.py``.

* :class:`RationalQuadraticKernel` --
  ``k = (1 + r^2 / (2 alpha sigma^2))^(-alpha)``, ``theta = [sigma, alpha]``;
* :class:`ARDRationalQuadraticKernel` --
  ``k = (1 + |(x - x') * beta|^2 / alpha)^(-alpha)``,
  ``theta = [beta_1 .. beta_p, alpha]``;
* :class:`PeriodicKernel` -- per-dimension ExpSineSquared,
  ``k = exp(-(2 / ell^2) sum_d sin^2(pi (x_d - x'_d) / period))``,
  ``theta = [period, ell]``;
* :class:`SpectralMixtureKernel` -- Wilson and Adams' Q-component
  spectral mixture, ``theta = [w (Q), mu (Q p), v (Q p)]``;
* :class:`DotProductKernel` -- ``k = sigma0^2 + <x, x'>``,
  ``theta = [sigma0]``;
* :class:`PolynomialKernel` -- ``k = (<x, x'> + c)^degree`` with a static
  integer degree, ``theta = [c]``.

The isotropic RQ, dot-product and polynomial maps are one definition each
in ``ops/streamed_matvec.py``, shared by ``gram``, ``gram_from_cache``
(over the cached squared distances or inner products), ``cross`` and the
matfree lane's streamed tiles.  The ARD-RQ, periodic and spectral-mixture
kernels weigh the inputs by theta, so they have neither a gram cache nor
a streaming form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import ARDHypers, Kernel, StationaryKernel
from spark_gp_tpu_torch.ops.distance import mxu_inner, sq_dist, sq_dist_self, weighted_sq_dist
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


class _TwoHyperStationary(StationaryKernel):
    """Two trainable hyperparameters ``theta = [h0, h1]``; ``lower`` /
    ``upper`` take a scalar or one bound per hyperparameter (default
    ``[1e-6, inf)``)."""

    n_hypers = 2

    def __init__(self, h0: float, h1: float, lower, upper):
        self.theta0_ = (float(h0), float(h1))
        self.lower_ = _pair(lower, 1e-6)
        self.upper_ = _pair(upper, math.inf)

    def _spec(self) -> tuple:
        return (self.theta0_, self.lower_, self.upper_)

    def init_theta(self):
        return np.array(self.theta0_, dtype=np.float64)

    def bounds(self):
        return (
            np.array(self.lower_, dtype=np.float64),
            np.array(self.upper_, dtype=np.float64),
        )


class RationalQuadraticKernel(_TwoHyperStationary):
    """Rational quadratic: ``k = (1 + r^2 / (2 alpha sigma^2))^(-alpha)``,
    ``theta = [sigma, alpha]``."""

    def __init__(self, sigma: float = 1.0, alpha: float = 1.0,
                 lower=None, upper=None):
        super().__init__(sigma, alpha, lower, upper)

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

    def describe(self, theta) -> str:
        t = np.asarray(theta)
        return f"RationalQuadraticKernel(sigma={float(t[0]):.1e}, alpha={float(t[1]):.1e})"


class ARDRationalQuadraticKernel(ARDHypers):
    """ARD rational quadratic ``k = (1 + |(x - x') * beta|^2 / alpha)^-alpha``
    (``alpha -> inf`` gives the ARD-RBF with the same betas).  ``theta =
    [beta_1 .. beta_p, alpha]``: the betas bounded as :class:`ARDHypers`
    (default ``[0, inf)``), ``alpha`` in ``[alpha_lower, alpha_upper]``."""

    def __init__(self, p_or_beta, beta: float = 1.0, alpha: float = 1.0,
                 lower=0.0, upper=math.inf,
                 alpha_lower: float = 1e-6, alpha_upper: float = math.inf):
        super().__init__(p_or_beta, beta, lower, upper)
        self.alpha0 = float(alpha)
        self.alpha_bounds = (float(alpha_lower), float(alpha_upper))
        self.n_hypers = self.beta0.shape[0] + 1

    def _spec(self) -> tuple:
        return super()._spec() + (self.alpha0, self.alpha_bounds)

    def init_theta(self):
        return np.concatenate([self.beta0, [self.alpha0]])

    def bounds(self):
        return (
            np.concatenate([self.lower_b, [self.alpha_bounds[0]]]),
            np.concatenate([self.upper_b, [self.alpha_bounds[1]]]),
        )

    def _k(self, theta, x_a, x_b):
        beta, alpha = theta[:-1], theta[-1]
        base = 1.0 + weighted_sq_dist(x_a, x_b, beta) / alpha
        # the exp/log form: the alpha-gradient goes through log(base)
        return torch.exp(-alpha * torch.log(base))

    def gram(self, theta, x):
        return self._k(theta, x, x)

    def cross(self, theta, x_test, x_train):
        return self._k(theta, x_test, x_train)

    def describe(self, theta) -> str:
        t = np.asarray(theta)
        vals = ", ".join(f"{v:.1e}" for v in t[:-1])
        return f"ARDRationalQuadraticKernel(beta=[{vals}], alpha={float(t[-1]):.1e})"


class PeriodicKernel(_TwoHyperStationary):
    """Per-dimension ExpSineSquared,
    ``k = exp(-(2 / ell^2) sum_d sin^2(pi (x_d - x'_d) / period))``,
    ``theta = [period, ell]``.  With ``Phi(x) = [cos(2 pi x / period),
    sin(2 pi x / period)]``, ``sum_d cos(2 pi (x_d - x'_d) / period) =
    <Phi(x), Phi(x')>``, so ``k = exp((<Phi, Phi'> - p) / ell^2)``: one
    feature-map contraction on the gram lane (``ops/distance.mxu_inner``),
    the exponent clamped at 0 so the cancellation of its O(p) terms never
    lifts k above 1."""

    def __init__(self, period: float = 1.0, lengthscale: float = 1.0,
                 lower=None, upper=None):
        super().__init__(period, lengthscale, lower, upper)

    @staticmethod
    def _phi(theta, x):
        u = (2.0 * math.pi / theta[0]) * x
        return torch.cat([torch.cos(u), torch.sin(u)], dim=-1)

    def _k(self, theta, x_a, x_b):
        ell2 = theta[1] * theta[1]
        cos_sum = mxu_inner(self._phi(theta, x_a), self._phi(theta, x_b))
        return torch.exp(torch.clamp_max(cos_sum - x_a.shape[-1], 0.0) / ell2)

    def gram(self, theta, x):
        return self._k(theta, x, x)

    def cross(self, theta, x_test, x_train):
        return self._k(theta, x_test, x_train)

    def describe(self, theta) -> str:
        t = np.asarray(theta)
        return f"PeriodicKernel(period={float(t[0]):.1e}, ell={float(t[1]):.1e})"


class SpectralMixtureKernel(Kernel):
    """Spectral mixture (Wilson and Adams, ICML 2013, eq. 12):
    ``k(tau) = sum_q w_q prod_d exp(-2 pi^2 tau_d^2 v_qd)
    cos(2 pi tau_d mu_qd)`` with ``tau = x - x'``.

    ``theta = [w (Q), mu (Q * p, row-major), v (Q * p)]``; ``w`` and ``mu``
    in ``[0, inf)``, ``v`` in ``[1e-6, inf)``.  Defaults: ``w = 1 / Q``,
    ``mu_q = (q + 1) / (2 Q)`` in every dimension, ``v = 1``.  The gram
    broadcasts ``tau`` over the stack, ``[..., n, n', p]``, and the cosine
    product over the components, ``[..., Q, n, n', p]``: meant for the
    low-dimensional inputs the kernel is used on (time series)."""

    def __init__(self, p: int, q: int = 3, weights=None, means=None,
                 scales=None):
        self.p = int(p)
        self.q = int(q)
        w = np.full(self.q, 1.0 / self.q) if weights is None else (
            np.asarray(weights, dtype=np.float64)
        )
        if means is None:
            mu = np.tile(
                ((np.arange(self.q) + 1.0) / (2.0 * self.q))[:, None], (1, self.p)
            )
        else:
            mu = np.asarray(means, dtype=np.float64)
        v = np.ones((self.q, self.p)) if scales is None else (
            np.asarray(scales, dtype=np.float64)
        )
        if w.shape != (self.q,) or mu.shape != (self.q, self.p) \
                or v.shape != (self.q, self.p):
            raise ValueError(
                f"weights must be [{self.q}], means/scales [{self.q}, "
                f"{self.p}]; got {w.shape}, {mu.shape}, {v.shape}"
            )
        self.w0, self.mu0, self.v0 = w, mu.ravel(), v.ravel()
        self.n_hypers = self.q * (1 + 2 * self.p)

    def _spec(self) -> tuple:
        return (self.p, self.q, tuple(float(v) for v in self.w0), tuple(float(v) for v in self.mu0),
                tuple(float(v) for v in self.v0))

    def init_theta(self):
        return np.concatenate([self.w0, self.mu0, self.v0])

    def bounds(self):
        n_qp = self.q * self.p
        lower = np.concatenate(
            [np.zeros(self.q), np.zeros(n_qp), np.full(n_qp, 1e-6)]
        )
        return lower, np.full(self.q + 2 * n_qp, math.inf)

    def _split(self, theta):
        q, p = self.q, self.p
        return (theta[:q], theta[q:q + q * p].reshape(q, p),
                theta[q + q * p:].reshape(q, p))

    def _k(self, theta, x_a, x_b):
        w, mu, v = self._split(theta)
        tau = x_a[..., :, None, :] - x_b[..., None, :, :]  # [..., n, n', p]
        expo = torch.einsum("...abp,qp->...qab", tau * tau,
                            (-2.0 * math.pi ** 2) * v)
        cos = torch.cos((2.0 * math.pi) * tau[..., None, :, :, :] * mu[:, None, None, :])
        # the product over the p inputs, multiplied out: torch.prod's
        # backward counts zero factors on the host, which a CUDA graph
        # (the device optimizer's captured step) cannot hold
        cosp = cos[..., 0]
        for d in range(1, self.p):
            cosp = cosp * cos[..., d]  # [..., q, n, n']
        return torch.einsum("q,...qab->...ab", w, torch.exp(expo) * cosp)

    def gram(self, theta, x):
        return self._k(theta, x, x)

    def cross(self, theta, x_test, x_train):
        return self._k(theta, x_test, x_train)

    def diag(self, theta, x):
        w = theta[: self.q]
        return torch.sum(w) * torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)

    def self_diag(self, theta, x):
        return self.diag(theta, x)

    def describe(self, theta) -> str:
        w, mu, _ = self._split(np.asarray(theta))
        top = int(np.argmax(w))
        return (f"SpectralMixtureKernel(q={self.q}, p={self.p}, w_top={float(w[top]):.1e}, "
                f"mu_top={np.round(np.asarray(mu[top]), 3).tolist()})")


class _OneHyper(Kernel):
    """One trainable hyperparameter ``h`` in ``[lower, upper]``."""

    n_hypers = 1

    def __init__(self, h: float, lower: float, upper: float):
        self.h0 = float(h)
        self.lower = float(lower)
        self.upper = float(upper)

    def _spec(self) -> tuple:
        return (self.h0, self.lower, self.upper)

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
        return mxu_inner(x, x)

    def prepare_matvec(self, x):
        return x


class DotProductKernel(_OneHyper):
    """Linear kernel ``k(x, x') = sigma0^2 + <x, x'>`` (non-stationary);
    ``theta = [sigma0]``, trainable in ``[0, inf)`` by default."""

    def __init__(self, sigma0: float = 1.0, lower: float = 0.0,
                 upper: float = math.inf):
        super().__init__(sigma0, lower, upper)

    def gram(self, theta, x):
        return dot_tile(theta, mxu_inner(x, x))

    def gram_from_cache(self, theta, cache):
        return dot_tile(theta, cache)

    def cross(self, theta, x_test, x_train):
        return dot_tile(theta, mxu_inner(x_test, x_train))

    def diag(self, theta, x):
        return dot_tile(theta, torch.sum(x * x, dim=-1))

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, "dot", theta)

    def describe(self, theta) -> str:
        return f"DotProductKernel(sigma0={float(np.asarray(theta)[0]):.1e})"


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

    def _spec(self) -> tuple:
        return (self.degree,) + super()._spec()

    def gram(self, theta, x):
        return poly_tile(theta, mxu_inner(x, x), self.degree)

    def gram_from_cache(self, theta, cache):
        return poly_tile(theta, cache, self.degree)

    def cross(self, theta, x_test, x_train):
        return poly_tile(theta, mxu_inner(x_test, x_train), self.degree)

    def diag(self, theta, x):
        return poly_tile(theta, torch.sum(x * x, dim=-1), self.degree)

    def matvec_from_prepared(self, theta, mcache, v):
        return streamed_matvec(mcache, v, "poly", theta, self.degree)

    def describe(self, theta) -> str:
        return f"PolynomialKernel(degree={self.degree}, c={float(np.asarray(theta)[0]):.1e})"
