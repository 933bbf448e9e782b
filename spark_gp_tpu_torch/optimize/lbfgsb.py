"""Box-constrained L-BFGS-B on the host driving the device objective.

SciPy's L-BFGS-B walks theta on the host; every evaluation is one device
value-and-gradient (``models/likelihood.py``) that hands back a Python
float and a float64 numpy gradient -- one device sync per evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import scipy.optimize

from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException


@dataclass
class OptimizeResult:
    theta: np.ndarray
    fun: float
    nit: int
    nfev: int
    success: bool
    message: str
    #: the checkpointed iteration a resumed fit started from (0: a fresh fit)
    resumed_from_iteration: int = 0


def log_space_applicable(theta0, lower) -> bool:
    """Log-domain optimization needs strictly positive initial values and
    non-negative lower bounds."""
    return bool(np.all(np.asarray(theta0) > 0) and np.all(np.asarray(lower) >= 0))


def minimize_lbfgsb(
    value_and_grad: Callable,
    theta0: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    max_iter: int = 100,
    tol: float = 1e-6,
    callback: Optional[Callable] = None,
    log_space: bool = False,
) -> OptimizeResult:
    """Minimize ``value_and_grad`` subject to ``lower <= theta <= upper``.

    ``tol`` is both scipy's ``ftol`` and ``gtol``.  ``log_space=True``
    optimizes ``u = log(theta)`` (chain rule on the gradient, bounds mapped
    through log): GP likelihoods are badly scaled in linear coordinates.
    A non-finite value at the first evaluation raises
    :class:`NotPositiveDefiniteException`; a later one (a non-PD trial
    point of a line search) returns a large finite value with a zero
    gradient so the search backtracks.  ``callback(theta)`` runs after
    each iteration with the linear-domain iterate (the checkpointer).
    """
    theta0 = np.asarray(theta0, dtype=np.float64)

    if log_space:
        if not log_space_applicable(theta0, lower):
            raise ValueError(
                "log-space optimization requires theta0 > 0 and lower >= 0"
            )
        inner = value_and_grad
        u0 = np.log(theta0)
        with np.errstate(divide="ignore"):
            lo_u = np.where(lower > 0, np.log(np.maximum(lower, 1e-300)), -np.inf)
            hi_u = np.where(np.isposinf(upper), np.inf, np.log(np.maximum(upper, 1e-300)))

        def value_and_grad_u(u):
            theta = np.exp(u)
            value, grad = inner(theta)
            return value, np.asarray(grad, dtype=np.float64) * theta

        callback_u = None if callback is None else (lambda u: callback(np.exp(u)))
        res = minimize_lbfgsb(
            value_and_grad_u, u0, lo_u, hi_u,
            max_iter=max_iter, tol=tol, callback=callback_u, log_space=False,
        )
        res.theta = np.exp(res.theta)
        return res
    bounds = list(
        zip(
            [None if np.isneginf(lo) else float(lo) for lo in lower],
            [None if np.isposinf(hi) else float(hi) for hi in upper],
        )
    )

    nfev = 0

    def fun(theta):
        nonlocal nfev
        nfev += 1
        value, grad = value_and_grad(theta)
        value = float(value)
        grad = np.asarray(grad, dtype=np.float64)
        if not np.isfinite(value):
            if nfev == 1:
                raise NotPositiveDefiniteException()
            return 1e25, np.zeros_like(grad)
        return value, grad

    res = scipy.optimize.minimize(
        fun,
        theta0,
        jac=True,
        method="L-BFGS-B",
        bounds=bounds,
        callback=callback,
        options={"maxiter": max_iter, "ftol": tol, "gtol": tol},
    )
    return OptimizeResult(
        theta=np.asarray(res.x, dtype=np.float64),
        fun=float(res.fun),
        # scipy omits nit when L-BFGS-B exits before its first iteration
        nit=int(getattr(res, "nit", 0)),
        nfev=int(res.nfev),
        success=bool(res.success),
        message=str(res.message),
    )
