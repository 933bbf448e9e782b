"""Covariance-kernel algebra as plain classes over tensors.

A kernel is an immutable spec.  Its hyperparameters live in one flat vector
``theta`` with the JAX package's layout and bounds -- composites concatenate
their children's vectors, a trainable scale prepends its coefficient -- so a
theta moves between the two packages unchanged.  ``gram`` / ``cross`` /
``diag`` / ``self_diag`` are functions of ``(theta, x)`` that take tensors
with leading batch dimensions (``x [..., n, p]``) and are differentiated by
autograd.  ``init_theta`` and ``bounds`` are float64 numpy, for the host
optimizer.

The composition DSL is the JAX package's:

>>> k = 1.0 * RBFKernel(0.1, 1e-6, 10) + WhiteNoiseKernel(0.5, 0, 1)
>>> k = Scalar(1.0).between(0).and_(30) * ARDRBFKernel(5)
>>> k = Const(1.0) * EyeKernel()

The theta-invariant gram cache (``prepare`` / ``gram_from_cache``,
:func:`prepare_gram_cache`): kernels whose gram factors through a
structure that does not depend on theta -- the squared-distance block of
the isotropic RBF, Matern and rational-quadratic kernels, the inner
products of the dot-product and polynomial kernels -- build it once per
fit, and every objective evaluation then pays only the elementwise theta
map.  ARD kernels (theta-weighted distances) keep ``prepare = None``, and
a composite drops it when a child lacks it.  ``GP_GRAM_CACHE=0`` turns
the cache off for every later fit (:func:`gram_cache_enabled`).

The matrix-free matvec protocol (``prepare_matvec`` /
``matvec_from_prepared``, :func:`supports_matfree`) lets the matfree
solver lane apply a kernel's gram without building it.

``k1 * k2`` of two kernels is their elementwise (Schur) product
(:class:`ProductKernel`), and :class:`ThetaOverrideKernel` restarts a
kernel from another starting point (``setNumRestarts``).
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch

from spark_gp_tpu_torch.ops.linalg import masked_kernel_matrix


class Kernel:
    """Covariance-function spec.  Immutable; all compute methods are pure.

    * ``n_hypers`` -- number of trainable hyperparameters.
    * ``init_theta()`` / ``bounds()`` -- float64 numpy ``[n_hypers]``.
    * ``gram(theta, x)`` -- ``[..., n, n]`` training kernel matrix.
    * ``cross(theta, x_test, x_train)`` -- ``[..., t, n]`` cross kernel.
    * ``diag(theta, x)`` / ``self_diag(theta, x)`` -- ``[..., n]``.
    * ``white_noise_var(theta)`` -- scalar white-noise variance.
    * ``prepare(x)`` / ``gram_from_cache(theta, cache)`` -- the
      theta-invariant cache: ``gram_from_cache(theta, prepare(x))`` equals
      ``gram(theta, x)``.  ``None`` (the class default) means the kernel
      has no invariant; composites null it per instance when a child
      lacks it, so ``prepare is None`` is the one capability test.
    * ``prepare_matvec(x)`` / ``matvec_from_prepared(theta, mcache, v)`` --
      the matrix-free streaming hooks: ``prepare_matvec`` returns the
      theta-invariant streaming operand (the ``[..., s, p]`` row stack
      itself for every streamed family), ``matvec_from_prepared`` computes
      ``gram(theta, x) @ v`` for ``v [..., s, n]`` without building the
      gram (``ops/streamed_matvec.py``).  ``None`` (the class default)
      means "cannot stream"; composites null both per instance when a
      child lacks them, so ``matvec_from_prepared is None`` is the one
      capability test (:func:`supports_matfree`).
    """

    n_hypers: int = 0
    prepare = None
    prepare_matvec = None
    matvec_from_prepared = None

    def _spec(self) -> tuple:
        """The spec identity of the JAX package's kernel of the same name:
        its constants, children included, which device checkpoints
        fingerprint (``utils/checkpoint.spec_fingerprint``)."""
        return ()

    def describe(self, theta) -> str:
        """The JAX package's human-readable render of the kernel at
        ``theta``, string for string; ``describe(zeros)`` is the host
        checkpoint's structural signature (``utils/checkpoint.py``)."""
        return type(self).__name__

    def init_theta(self) -> np.ndarray:
        return np.zeros((0,), dtype=np.float64)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        zero = np.zeros((0,), dtype=np.float64)
        return zero, zero

    def gram(self, theta, x):
        raise NotImplementedError

    def cross(self, theta, x_test, x_train):
        raise NotImplementedError

    def diag(self, theta, x):
        raise NotImplementedError

    def self_diag(self, theta, x):
        raise NotImplementedError

    def gram_from_cache(self, theta, cache):
        raise NotImplementedError(
            f"{type(self).__name__} has no theta-invariant structure "
            "(prepare is None); check kernel.prepare before taking the "
            "cached gram path"
        )

    def white_noise_var(self, theta):
        return torch.zeros((), dtype=theta.dtype, device=theta.device)

    # --- composition DSL -------------------------------------------------
    def __add__(self, other: "Kernel") -> "SumKernel":
        return SumKernel(self, other)

    def __rmul__(self, coeff: float) -> "Kernel":
        """``c * kernel`` makes the coefficient trainable in ``[0, inf)``."""
        return Scalar(float(coeff)) * self

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return Scalar(float(other)) * self
        if isinstance(other, Kernel):
            return ProductKernel(self, other)
        return NotImplemented


def _ones(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


class StationaryKernel(Kernel):
    """Base for unit-variance stationary kernels: ``k(x, x) = 1``."""

    def diag(self, theta, x):
        return _ones(x)

    def self_diag(self, theta, x):
        return _ones(x)


class ScalarLengthscaleHypers(StationaryKernel):
    """One trainable length-scale ``sigma`` bounded in ``[lower, upper]``."""

    n_hypers = 1

    def __init__(self, sigma: float = 1.0, lower: float = 1e-6,
                 upper: float = math.inf):
        self.sigma0 = float(sigma)
        self.lower = float(lower)
        self.upper = float(upper)

    def _spec(self) -> tuple:
        return (self.sigma0, self.lower, self.upper)

    def init_theta(self):
        return np.array([self.sigma0], dtype=np.float64)

    def bounds(self):
        return (
            np.array([self.lower], dtype=np.float64),
            np.array([self.upper], dtype=np.float64),
        )


class ARDHypers(StationaryKernel):
    """One trainable inverse length-scale ``beta`` per feature (``beta``
    multiplies).  Built from a dimension count (uniform init) or a vector."""

    def __init__(self, p_or_beta, beta: float = 1.0, lower=0.0,
                 upper=math.inf):
        if isinstance(p_or_beta, (int, np.integer)):
            beta0 = np.full((int(p_or_beta),), float(beta), dtype=np.float64)
        else:
            beta0 = np.asarray(p_or_beta, dtype=np.float64)
        self.beta0 = beta0
        self.n_hypers = beta0.shape[0]
        self.lower_b = np.broadcast_to(
            np.asarray(lower, dtype=np.float64), beta0.shape
        ).copy()
        self.upper_b = np.broadcast_to(
            np.asarray(upper, dtype=np.float64), beta0.shape
        ).copy()

    def _spec(self) -> tuple:
        return (tuple(self.beta0.tolist()), tuple(self.lower_b.tolist()),
                tuple(self.upper_b.tolist()))

    def init_theta(self):
        return self.beta0.copy()

    def bounds(self):
        return self.lower_b, self.upper_b


def _identity_stack(x):
    """``[..., n, n]`` identities for rows ``x [..., n, *]``."""
    n = x.shape[-2]
    return torch.eye(n, dtype=x.dtype, device=x.device).expand(*x.shape[:-2], n, n)


class EyeKernel(Kernel):
    """Identity kernel: ``K = I`` on training points, 0 across sets, unit
    white-noise variance."""

    n_hypers = 0

    def gram(self, theta, x):
        return _identity_stack(x)

    def cross(self, theta, x_test, x_train):
        shape = x_test.shape[:-1] + x_train.shape[-2:-1]
        return torch.zeros(shape, dtype=x_train.dtype, device=x_train.device)

    def diag(self, theta, x):
        return _ones(x)

    def self_diag(self, theta, x):
        return _ones(x)

    def white_noise_var(self, theta):
        return torch.ones((), dtype=theta.dtype, device=theta.device)

    def describe(self, theta) -> str:
        return "I"

    def prepare(self, x):
        # a zero-byte carrier of the batch shape, n, dtype and device:
        # the identity needs nothing else
        return x.new_zeros(x.shape[:-1] + (0,))

    def gram_from_cache(self, theta, cache):
        return _identity_stack(cache)

    def prepare_matvec(self, x):
        return None  # the identity needs no operand

    def matvec_from_prepared(self, theta, mcache, v):
        return v


class ThetaOverrideKernel(Kernel):
    """The same kernel started from another hyperparameter point: every
    computation is the wrapped kernel's, ``init_theta`` is ``theta0``.
    Restart r of ``setNumRestarts`` wraps the model kernel this way, so
    the fit path runs unchanged."""

    def __init__(self, inner: Kernel, theta0) -> None:
        self.inner = inner
        self.theta0_ = tuple(float(v) for v in np.asarray(theta0).ravel())
        if len(self.theta0_) != inner.n_hypers:
            raise ValueError(
                f"theta0 has {len(self.theta0_)} entries; kernel has "
                f"{inner.n_hypers} hyperparameters"
            )
        self.n_hypers = inner.n_hypers
        if inner.prepare is None:
            self.prepare = None
        if inner.matvec_from_prepared is None:
            self.prepare_matvec = None
            self.matvec_from_prepared = None

    def _spec(self) -> tuple:
        return (self.inner,)

    def init_theta(self):
        return np.array(self.theta0_, dtype=np.float64)

    def bounds(self):
        return self.inner.bounds()

    def gram(self, theta, x):
        return self.inner.gram(theta, x)

    def cross(self, theta, x_test, x_train):
        return self.inner.cross(theta, x_test, x_train)

    def diag(self, theta, x):
        return self.inner.diag(theta, x)

    def self_diag(self, theta, x):
        return self.inner.self_diag(theta, x)

    def prepare(self, x):
        # the cache does not depend on theta: every restart shares one
        return self.inner.prepare(x)

    def gram_from_cache(self, theta, cache):
        return self.inner.gram_from_cache(theta, cache)

    def prepare_matvec(self, x):
        return self.inner.prepare_matvec(x)

    def matvec_from_prepared(self, theta, mcache, v):
        return self.inner.matvec_from_prepared(theta, mcache, v)

    def white_noise_var(self, theta):
        return self.inner.white_noise_var(theta)

    def describe(self, theta) -> str:
        return self.inner.describe(theta)


class _PairKernel(Kernel):
    """Binary composites: the children's theta vectors and bounds
    concatenate (``k1`` first); the composite's gram cache and streaming
    hooks exist only when both children have them."""

    def __init__(self, k1: Kernel, k2: Kernel) -> None:
        self.k1 = k1
        self.k2 = k2
        self.n_hypers = k1.n_hypers + k2.n_hypers
        if k1.prepare is None or k2.prepare is None:
            # the cache is the pair of the children's: both or neither
            self.prepare = None
        if k1.matvec_from_prepared is None or k2.matvec_from_prepared is None:
            # streaming composes: both children or neither
            self.prepare_matvec = None
            self.matvec_from_prepared = None

    def _split(self, theta):
        return theta[: self.k1.n_hypers], theta[self.k1.n_hypers:]

    def _spec(self) -> tuple:
        return (self.k1, self.k2)

    def init_theta(self):
        return np.concatenate([self.k1.init_theta(), self.k2.init_theta()])

    def bounds(self):
        lo1, hi1 = self.k1.bounds()
        lo2, hi2 = self.k2.bounds()
        return np.concatenate([lo1, lo2]), np.concatenate([hi1, hi2])

    def prepare(self, x):
        return self.k1.prepare(x), self.k2.prepare(x)


class SumKernel(_PairKernel):
    """``k1 + k2`` with concatenated hyperparameter vectors (``k1`` first)."""

    def gram(self, theta, x):
        t1, t2 = self._split(theta)
        return self.k1.gram(t1, x) + self.k2.gram(t2, x)

    def gram_from_cache(self, theta, cache):
        t1, t2 = self._split(theta)
        c1, c2 = cache
        return self.k1.gram_from_cache(t1, c1) + self.k2.gram_from_cache(t2, c2)

    def prepare_matvec(self, x):
        return self.k1.prepare_matvec(x), self.k2.prepare_matvec(x)

    def matvec_from_prepared(self, theta, mcache, v):
        # (K1 + K2) v = K1 v + K2 v: two streamed passes, still no gram
        t1, t2 = self._split(theta)
        c1, c2 = mcache
        return (self.k1.matvec_from_prepared(t1, c1, v)
                + self.k2.matvec_from_prepared(t2, c2, v))

    def cross(self, theta, x_test, x_train):
        t1, t2 = self._split(theta)
        return self.k1.cross(t1, x_test, x_train) + self.k2.cross(t2, x_test, x_train)

    def diag(self, theta, x):
        t1, t2 = self._split(theta)
        return self.k1.diag(t1, x) + self.k2.diag(t2, x)

    def self_diag(self, theta, x):
        t1, t2 = self._split(theta)
        return self.k1.self_diag(t1, x) + self.k2.self_diag(t2, x)

    def white_noise_var(self, theta):
        t1, t2 = self._split(theta)
        return self.k1.white_noise_var(t1) + self.k2.white_noise_var(t2)

    def describe(self, theta) -> str:
        t1, t2 = self._split(np.asarray(theta))
        return " + ".join(p for p in (self.k1.describe(t1), self.k2.describe(t2)) if p)


class ProductKernel(_PairKernel):
    """``k1 * k2``: the elementwise (Schur) product of two kernels, PSD by
    the Schur product theorem; ``RBFKernel(..) * PeriodicKernel(..)`` is
    the quasi-periodic kernel.  Its ``white_noise_var`` is 0, and a factor
    that carries white noise is refused (:func:`_carries_white_noise`):
    add the noise at the top level, ``k1 * k2 + WhiteNoiseKernel(...)``.
    The gram cache is the pair of the factors' caches; a product does not
    stream."""

    def __init__(self, k1: Kernel, k2: Kernel) -> None:
        super().__init__(k1, k2)
        for factor in (k1, k2):
            if _carries_white_noise(factor):
                raise ValueError(
                    "kernel products cannot contain white-noise factors "
                    "(the product's delta ridge is not representable as a "
                    "flat white_noise_var); add the noise at the top "
                    "level: k1 * k2 + WhiteNoiseKernel(...)"
                )

    def gram(self, theta, x):
        t1, t2 = self._split(theta)
        return self.k1.gram(t1, x) * self.k2.gram(t2, x)

    def gram_from_cache(self, theta, cache):
        t1, t2 = self._split(theta)
        c1, c2 = cache
        return self.k1.gram_from_cache(t1, c1) * self.k2.gram_from_cache(t2, c2)

    def cross(self, theta, x_test, x_train):
        t1, t2 = self._split(theta)
        return self.k1.cross(t1, x_test, x_train) * self.k2.cross(t2, x_test, x_train)

    def diag(self, theta, x):
        t1, t2 = self._split(theta)
        return self.k1.diag(t1, x) * self.k2.diag(t2, x)

    def self_diag(self, theta, x):
        t1, t2 = self._split(theta)
        return self.k1.self_diag(t1, x) * self.k2.self_diag(t2, x)

    def describe(self, theta) -> str:
        t1, t2 = self._split(np.asarray(theta))
        return f"({self.k1.describe(t1)}) * ({self.k2.describe(t2)})"


class TrainableScaleKernel(Kernel):
    """``C * k`` with trainable ``C`` prepended to the hyperparameters."""

    def __init__(self, kernel: Kernel, c: float, lower: float = 0.0,
                 upper: float = math.inf):
        if c < 0:
            raise ValueError("C should be non-negative")
        self.kernel = kernel
        self.c0 = float(c)
        self.lower = float(lower)
        self.upper = float(upper)
        self.n_hypers = 1 + kernel.n_hypers
        if kernel.prepare is None:
            self.prepare = None
        if kernel.matvec_from_prepared is None:
            self.prepare_matvec = None
            self.matvec_from_prepared = None

    def _spec(self) -> tuple:
        return (self.kernel, self.c0, self.lower, self.upper)

    def init_theta(self):
        return np.concatenate([[self.c0], self.kernel.init_theta()])

    def bounds(self):
        lo, hi = self.kernel.bounds()
        return (
            np.concatenate([[self.lower], lo]),
            np.concatenate([[self.upper], hi]),
        )

    def gram(self, theta, x):
        return theta[0] * self.kernel.gram(theta[1:], x)

    def prepare(self, x):
        return self.kernel.prepare(x)

    def gram_from_cache(self, theta, cache):
        return theta[0] * self.kernel.gram_from_cache(theta[1:], cache)

    def prepare_matvec(self, x):
        return self.kernel.prepare_matvec(x)

    def matvec_from_prepared(self, theta, mcache, v):
        # (C K) v = C (K v): the scale rides outside the stream
        return theta[0] * self.kernel.matvec_from_prepared(theta[1:], mcache, v)

    def cross(self, theta, x_test, x_train):
        return theta[0] * self.kernel.cross(theta[1:], x_test, x_train)

    def diag(self, theta, x):
        return theta[0] * self.kernel.diag(theta[1:], x)

    def self_diag(self, theta, x):
        return theta[0] * self.kernel.self_diag(theta[1:], x)

    def white_noise_var(self, theta):
        return theta[0] * self.kernel.white_noise_var(theta[1:])

    def describe(self, theta) -> str:
        t = np.asarray(theta)
        return f"{float(t[0]):.1e} * {self.kernel.describe(t[1:])}"


class ConstScaleKernel(Kernel):
    """``C * k`` with a fixed, non-trainable ``C``."""

    def __init__(self, kernel: Kernel, c: float):
        if c < 0:
            raise ValueError("C should be non-negative")
        self.kernel = kernel
        self.c = float(c)
        self.n_hypers = kernel.n_hypers
        if kernel.prepare is None:
            self.prepare = None
        if kernel.matvec_from_prepared is None:
            self.prepare_matvec = None
            self.matvec_from_prepared = None

    def _spec(self) -> tuple:
        return (self.kernel, self.c)

    def init_theta(self):
        return self.kernel.init_theta()

    def bounds(self):
        return self.kernel.bounds()

    def gram(self, theta, x):
        return self.c * self.kernel.gram(theta, x)

    def prepare(self, x):
        return self.kernel.prepare(x)

    def gram_from_cache(self, theta, cache):
        return self.c * self.kernel.gram_from_cache(theta, cache)

    def prepare_matvec(self, x):
        return self.kernel.prepare_matvec(x)

    def matvec_from_prepared(self, theta, mcache, v):
        return self.c * self.kernel.matvec_from_prepared(theta, mcache, v)

    def cross(self, theta, x_test, x_train):
        return self.c * self.kernel.cross(theta, x_test, x_train)

    def diag(self, theta, x):
        return self.c * self.kernel.diag(theta, x)

    def self_diag(self, theta, x):
        return self.c * self.kernel.self_diag(theta, x)

    def white_noise_var(self, theta):
        return self.c * self.kernel.white_noise_var(theta)

    def describe(self, theta) -> str:
        if self.c == 0:
            return ""
        return f"{self.c:.1e} * {self.kernel.describe(np.asarray(theta))}"


def _carries_white_noise(kernel: Kernel) -> bool:
    """Can ``kernel`` ever contribute a white-noise ridge?  A walk of the
    composition for ``EyeKernel``, not a probe at one theta: a trainable
    noise that starts at 0 (``WhiteNoiseKernel(0.0, 0, 1)``) can train to
    a ridge.  A ``Const(0) * ...`` branch is inert.  Kernels outside the
    algebra are probed at their initial theta."""
    if isinstance(kernel, EyeKernel):
        return True
    if isinstance(kernel, _PairKernel):
        return _carries_white_noise(kernel.k1) or _carries_white_noise(kernel.k2)
    if isinstance(kernel, TrainableScaleKernel):
        return _carries_white_noise(kernel.kernel)
    if isinstance(kernel, ConstScaleKernel):
        return kernel.c != 0.0 and _carries_white_noise(kernel.kernel)
    if isinstance(kernel, ThetaOverrideKernel):
        return _carries_white_noise(kernel.inner)
    return float(kernel.white_noise_var(torch.as_tensor(kernel.init_theta()))) != 0.0


class Scalar:
    """Scalar-coefficient builder:

    >>> Scalar(1.0) * k                      # trainable in [0, inf)
    >>> Scalar(1.0).between(0).and_(30) * k  # trainable in [0, 30]
    >>> Scalar(1.0).below(10) * k            # trainable in [0, 10]
    >>> Scalar(1.0).const * k                # fixed
    """

    def __init__(self, c: float, lower: float = 0.0, upper: float = math.inf,
                 trainable: bool = True):
        if trainable and not lower < upper:
            raise ValueError(
                "The scalar should either have its lower limit below its upper "
                "limit or not be trainable"
            )
        self.c = float(c)
        self.lower = lower
        self.upper = upper
        self.trainable = trainable

    def __mul__(self, kernel: Kernel) -> Kernel:
        if self.trainable:
            return TrainableScaleKernel(kernel, self.c, self.lower, self.upper)
        return ConstScaleKernel(kernel, self.c)

    def between(self, lower: float) -> "_Between":
        return _Between(self.c, lower, self.trainable)

    def below(self, upper: float) -> "Scalar":
        return Scalar(self.c, self.lower, upper, self.trainable)

    @property
    def const(self) -> "Scalar":
        return Scalar(self.c, self.c, self.c, trainable=False)


class _Between:
    def __init__(self, c: float, lower: float, trainable: bool):
        self._c = c
        self._lower = lower
        self._trainable = trainable

    def and_(self, upper: float) -> Scalar:
        return Scalar(self._c, self._lower, upper, self._trainable)


def Const(c: float) -> Scalar:
    """``Const(0.5) * k`` -- a fixed scalar times a kernel."""
    return Scalar(c).const


def WhiteNoiseKernel(initial: float, lower: float, upper: float) -> Kernel:
    """Trainable white noise: ``(initial between lower and upper) * EyeKernel``."""
    return Scalar(initial, lower, upper) * EyeKernel()


def supports_matfree(kernel: Kernel) -> bool:
    """True when ``kernel`` (and, for composites, every child) implements
    the streaming matvec protocol, so it can run the matrix-free solver
    lane.  ``False`` -- ARD metrics, custom kernels -- keeps the
    materialized path."""
    return kernel.matvec_from_prepared is not None


def gram_cache_enabled() -> bool:
    """The process knob: ``GP_GRAM_CACHE=0`` turns the gram cache off for
    every fit (each evaluation then rebuilds the distances, as before the
    cache).  Read on the host when a fit builds its cache."""
    return os.environ.get("GP_GRAM_CACHE", "1") != "0"


def supports_gram_cache(kernel: Kernel) -> bool:
    """True when ``kernel`` has a theta-invariant structure and the knob
    has not turned the cache off."""
    return kernel.prepare is not None and gram_cache_enabled()


@torch.no_grad()
def prepare_gram_cache(kernel: Kernel, x):
    """The per-expert theta-invariant cache of an ``[E, s, p]`` stack, one
    ``prepare`` pass in the stack's dtype on its device, on the precision
    lane in effect (``ops/precision.py``); ``None`` when the kernel has no
    invariant or ``GP_GRAM_CACHE=0``.  A fit builds it once, so the lane's
    gram (the mixed lane's 3xTF32 distances) is paid once a fit, and the
    cached distances are the ones the per-evaluation build would give at
    that lane."""
    if not supports_gram_cache(kernel):
        return None
    return kernel.prepare(x)


def masked_gram_stack(kernel: Kernel, theta, x, mask, cache=None):
    """``[E, s, s]`` stack of masked per-expert grams from ``x [E, s, p]``
    and ``mask [E, s]`` -- the gram build of every fit objective.  With a
    ``cache`` from :func:`prepare_gram_cache` the gram comes from
    ``gram_from_cache`` and ``x`` is not read: only the elementwise theta
    map is built (and differentiated) per evaluation."""
    if cache is None:
        return masked_kernel_matrix(kernel.gram(theta, x), mask)
    return masked_kernel_matrix(kernel.gram_from_cache(theta, cache), mask)
