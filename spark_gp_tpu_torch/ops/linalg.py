"""Cholesky-based dense linear algebra.

Every matrix on the hot path is SPD by construction (kernel + sigma2 I), so
one Cholesky gives the logdet (``2 sum log diag L``), solves by two
triangular solves, and a free PD check.  As in the JAX package, a non-PD
input yields a NaN factor -- never an exception -- so a failed expert
surfaces as a NaN objective.  The host-side jitter ladder
(:func:`cholesky_escalated`) repairs the one-time factorizations (the PPA
factors through :func:`psd_safe_cholesky_np`, the PoE predictor's expert
factors on the device, matrix by matrix) and raises
:class:`NotPositiveDefiniteException` when it is exhausted.
"""

from __future__ import annotations

import logging

import numpy as np
import torch


class NotPositiveDefiniteException(Exception):
    """Raised when a matrix that must be positive definite is not."""

    def __init__(self) -> None:
        super().__init__(
            "Some matrix which is supposed to be positive definite is not. "
            "This probably happened due to `sigma2` parameter being too small. "
            "Try to gradually increase it."
        )


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN-filled for each non-PD matrix."""
    chol, info = torch.linalg.cholesky_ex(mat)
    return torch.where((info == 0)[..., None, None], chol, float("nan"))


def is_pd(chol_l: torch.Tensor) -> bool:
    """Did the Cholesky succeed: is every entry of the factor finite."""
    return bool(torch.all(torch.isfinite(chol_l)))


def chol_logdet(chol_l: torch.Tensor) -> torch.Tensor:
    """log|K| from its Cholesky factor: ``2 * sum(log diag L)``."""
    return 2.0 * torch.log(torch.diagonal(chol_l, dim1=-2, dim2=-1)).sum(-1)


def chol_solve(chol_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``K x = b`` given ``L = cholesky(K)``; ``b`` is ``[..., n]`` or
    ``[..., n, k]``."""
    vec = b.ndim == chol_l.ndim - 1
    b2d = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(chol_l, b2d, upper=False)
    x = torch.linalg.solve_triangular(chol_l.mT, y, upper=True)
    return x[..., 0] if vec else x


# One bounded ladder of trace-relative diagonal boosts: unjittered first,
# then escalating from below the f64 noise floor up to 1.2e-4.
JITTER_SCHEDULE = (0.0, 1e-10, 1e-8, 1.2e-7, 1.2e-6, 1.2e-5, 1.2e-4)


def trace_scale(trace: torch.Tensor, n: int) -> torch.Tensor:
    """The unit of every trace-relative jitter: ``trace / n``, or 1 where
    the trace is not finite and positive."""
    return torch.where(torch.isfinite(trace) & (trace > 0.0), trace / n, torch.ones_like(trace))


def _jittered_cholesky(mat: torch.Tensor, tau: float) -> torch.Tensor:
    """One factorization attempt of a (batch of) matrix at trace-relative
    jitter ``tau``: ``sym + tau * trace_scale * I``; NaN for each matrix
    that fails."""
    n = mat.shape[-1]
    sym = 0.5 * (mat + mat.mT)
    scale = trace_scale(torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1), n)
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    return cholesky(sym + (tau * scale)[..., None, None] * eye)


def cholesky_escalated(mat: torch.Tensor, name: str = "matrix", schedule=JITTER_SCHEDULE):
    """Cholesky of a matrix or a batch under the jitter ladder, matrix by
    matrix: each rung refactors the batch at a larger ``tau``, and each
    matrix keeps the factor of the first rung that made it finite, so a
    healthy matrix keeps its unjittered factor.  A NaN input walks the
    ladder like an indefinite matrix.  Returns ``(chol, tau_max)``,
    ``tau_max`` the largest rung any matrix needed; raises
    :class:`NotPositiveDefiniteException` once the ladder is exhausted.
    For one-time factor builds (the PPA factors, the PoE predictor); the
    fit objectives leave a failed matrix NaN for quarantine instead."""
    out = done = None
    tau_max = 0.0
    for tau in schedule:
        chol_l = _jittered_cholesky(mat, tau)
        ok = torch.isfinite(chol_l).all(dim=-1).all(dim=-1)
        if out is None:
            out, done = chol_l, ok
        else:
            newly = ok & ~done
            if bool(newly.any()):
                out = torch.where(newly[..., None, None], chol_l, out)
                done = done | newly
                tau_max = tau
        if bool(done.all()):
            if tau_max:
                logging.getLogger("spark_gp_tpu_torch").warning(
                    "%s required relative jitter up to %.3e for positive "
                    "definiteness", name, tau_max,
                )
            return out, tau_max
    raise NotPositiveDefiniteException()


def psd_safe_cholesky_np(mat, name: str, schedule=JITTER_SCHEDULE):
    """Host numpy Cholesky under the escalating trace-relative jitter ladder
    (:func:`cholesky_escalated` on the host, in ``mat``'s dtype).

    Returns the lower factor; raises :class:`NotPositiveDefiniteException`
    once the whole ladder fails."""
    chol, _ = cholesky_escalated(torch.as_tensor(np.array(mat)), name, schedule)
    return chol.numpy()


def masked_kernel_matrix(kmat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Embed a masked gram into an identity so padded rows are inert: zero
    cross terms and a unit diagonal, so padding adds ``log 1 = 0`` to the
    logdet and nothing to the quadratic form."""
    mask2 = mask[..., :, None] * mask[..., None, :]
    eye = torch.eye(kmat.shape[-1], dtype=kmat.dtype, device=kmat.device)
    pad_diag = eye * (1.0 - mask[..., None, :])
    return kmat * mask2 + pad_diag
