"""The regression objectives: the BCM (product-of-experts) marginal
likelihood, and the dispatch to the LOO and ELBO objectives
(:func:`objective_fn`).

Per expert, with the noise-augmented kernel matrix K,

    NLL_e = 1/2 y^T K^-1 y + 1/2 log|K|      (constant term dropped)

and the objective is the sum over experts.  The gradient is autograd's.
The solver lane (``ops/iterative.py``) picks how the two terms are
computed, as in the JAX package:

* ``matfree`` (for kernels with the streaming protocol): CG / SLQ on the
  injected operator of :func:`masked_matfree_operator`; every product is
  the streamed kernel ``ops/streamed_matvec.py`` and the ``[E, s, s]``
  gram stack is never built;
* ``iterative`` (and ``matfree`` for a kernel that cannot stream): the
  same CG / SLQ engine on the materialized gram stack;
* ``exact``: on a CUDA float32 stack with ``s <= 512`` the batched
  inverse kernel (``ops/spd_linalg.spd_inv_logdet``), then
  ``alpha = K^-1 y``; anything else (the CPU, float64, larger experts)
  one batched Cholesky, one vector solve and the logdet from the
  diagonal.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack, supports_matfree
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops.linalg import chol_logdet, chol_solve, cholesky, trace_scale
from spark_gp_tpu_torch.ops.spd_linalg import kernel_applies, spd_inv_logdet
from spark_gp_tpu_torch.parallel.experts import ExpertData


def nll_from_inverse(kmat, ym, inv_logdet=spd_inv_logdet, weights=None):
    """Summed (or ``weights``-weighted) NLL of a ``[E, s, s]`` stack through
    an inverse + logdet function (the kernel branch)."""
    kinv, logdet = inv_logdet(kmat)
    alpha = torch.einsum("eij,ej->ei", kinv, ym)
    if weights is None:
        return 0.5 * torch.einsum("ei,ei->", ym, alpha) + 0.5 * torch.sum(logdet)
    return (0.5 * torch.einsum("ei,ei,e->", ym, alpha, weights)
            + 0.5 * torch.sum(weights * logdet))


def nll_from_cholesky(kmat, ym, weights=None):
    """Summed (or ``weights``-weighted) NLL of a ``[E, s, s]`` stack
    through one batched Cholesky."""
    chol_l = cholesky(kmat)
    alpha = chol_solve(chol_l, ym)
    if weights is None:
        return 0.5 * torch.einsum("ei,ei->", ym, alpha) + 0.5 * torch.sum(
            chol_logdet(chol_l)
        )
    return (0.5 * torch.einsum("ei,ei,e->", ym, alpha, weights)
            + 0.5 * torch.sum(weights * chol_logdet(chol_l)))


def _quad_logdet_nll(quad, logdet, weights):
    """The iterative lanes' NLL from per-expert ``quad`` and ``logdet``."""
    if weights is None:
        return 0.5 * torch.sum(quad) + 0.5 * torch.sum(logdet)
    return 0.5 * torch.sum(weights * quad) + 0.5 * torch.sum(weights * logdet)


def masked_matfree_operator(kernel: Kernel, theta, x, mask, jitter=None):
    """The masked (and optionally jittered) NLL operator as closures: the
    matfree lane's stand-in for ``masked_gram_stack``.

    With ``m`` the 0/1 mask the materialized operator is
    ``M K M + diag(1 - m) + c I`` (``c = jitter * trace / s``, the
    trace-relative ridge, when ``jitter`` -- a scalar or ``[E]`` -- is
    given), so its product is ``m * K(m * v) + ((1 - m) + c) * v``: the
    kernel's product streams, the masking and the ridge are O(s) dressing
    applied here.

    Returns ``(matvec, matvec_sg, diag_sg, col_fn_sg)`` for
    ``ops.iterative.inv_quad_logdet_matfree``: ``matvec`` differentiable in
    ``theta``, ``matvec_sg`` its detached twin, ``diag_sg [E, s]`` the
    detached diagonal and ``col_fn_sg(piv)`` the pivot-column oracle.  A
    column is ``kernel.cross`` against the single pivot row with its own
    entry pinned from ``diag_sg`` (the Eye ridge's ``cross`` is zero)."""
    s = x.shape[-2]
    mcache = kernel.prepare_matvec(x)
    mdiag = mask * kernel.diag(theta, x) + (1.0 - mask)
    if jitter is not None:
        scale = trace_scale(torch.sum(mdiag, dim=-1), s)
        c = torch.as_tensor(jitter, dtype=x.dtype, device=x.device) * scale
    else:
        c = x.new_zeros(mask.shape[:-1])
    diag_sg = (mdiag + c[..., None]).detach()
    theta_sg, c_sg = theta.detach(), c.detach()

    def _apply(th, cj, v):
        mv = mask[..., None] * kernel.matvec_from_prepared(th, mcache, mask[..., None] * v)
        return mv + ((1.0 - mask) + cj[..., None])[..., None] * v

    def matvec(v):
        return _apply(theta, c, v)

    def matvec_sg(v):
        return _apply(theta_sg, c_sg, v)

    iota = torch.arange(s, device=x.device)

    def col_fn_sg(piv):
        x_piv = torch.gather(x, -2, piv[..., None, None].expand(piv.shape + (1, x.shape[-1])))
        kcol = kernel.cross(theta_sg, x_piv, x)[..., 0, :]  # K[piv, :] = K[:, piv]
        m_piv = torch.gather(mask, -1, piv[..., None])
        d_piv = torch.gather(diag_sg, -1, piv[..., None])
        return torch.where(iota == piv[..., None], d_piv, mask * kcol * m_piv)

    return matvec, matvec_sg, diag_sg, col_fn_sg


def batched_nll(kernel: Kernel, theta, data: ExpertData, cache=None, jitter=None,
                weights=None):
    """Sum of per-expert NLLs over the ``[E, s, ...]`` stack, on the lane
    ``ops.iterative.resolve_solver`` picks for the expert size.  ``cache``
    is the fit's theta-invariant gram cache (``kernels/base.py``); the
    exact and iterative branches build the gram from it, the matfree
    branch never builds a gram and is never handed one.

    ``jitter`` (scalar or ``[E]``, trace-relative) is the recovery
    ladder's escalation operand (``resilience/quarantine.py``): every lane
    adds ``jitter * trace / s * I`` to each expert's operator.
    ``weights`` (``[E]``) is the aggregation plane's per-expert weight
    operand (``models/aggregation.py``): the objective becomes
    ``sum_e w_e NLL_e``.  ``None`` for either keeps the plain sum."""
    resolved = it_ops.resolve_for(data)
    ym = data.y * data.mask
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=data.x.dtype, device=data.x.device)
    if resolved == "matfree" and supports_matfree(kernel):
        # this branch runs before any gram is built: every product streams,
        # and the ridge rides the operator
        quad, logdet = it_ops.inv_quad_logdet_matfree(
            *masked_matfree_operator(kernel, theta, data.x, data.mask, jitter), ym
        )
        return _quad_logdet_nll(quad, logdet, weights)
    kmat = masked_gram_stack(kernel, theta, data.x, data.mask, cache)
    if jitter is not None:
        s = kmat.shape[-1]
        scale = trace_scale(torch.diagonal(kmat, dim1=-2, dim2=-1).sum(-1), s)
        boost = torch.as_tensor(jitter, dtype=kmat.dtype, device=kmat.device)
        kmat = kmat + (boost * scale)[..., None, None] * torch.eye(
            s, dtype=kmat.dtype, device=kmat.device)
    if resolved in ("iterative", "matfree"):
        quad, logdet = it_ops.inv_quad_logdet(kmat, ym)
        return _quad_logdet_nll(quad, logdet, weights)
    if kernel_applies(kmat):
        return nll_from_inverse(kmat, ym, weights=weights)
    return nll_from_cholesky(kmat, ym, weights=weights)


def objective_fn(objective: str):
    """The stack objective ``setObjective`` selects, as
    ``(kernel, theta, data, cache, *extra) -> scalar``: the BCM marginal
    NLL (:func:`batched_nll`, on the solver lane in effect; ``extra`` is
    the recovery loop's ``(jitter,)`` or ``(jitter, weights)``, absent
    on a clean fit), the negative LOO log pseudo-likelihood
    (``models/loo.py``; K1 or the Cholesky branch whatever the lane;
    ``extra`` ignored) or the negative Titsias ELBO (``models/sgpr.py``;
    ``extra = (active, sigma2)``, no gram cache)."""
    if objective == "marginal":
        return batched_nll
    if objective == "loo":
        from spark_gp_tpu_torch.models.loo import batched_loo_nll

        return lambda kernel, theta, data, cache, *extra: batched_loo_nll(
            kernel, theta, data, cache)
    if objective == "elbo":
        from spark_gp_tpu_torch.models.sgpr import batched_elbo_nll

        return lambda kernel, theta, data, cache, active, sigma2: batched_elbo_nll(
            kernel, theta, data, active, sigma2)
    raise ValueError(
        f"unknown objective {objective!r}; expected 'marginal', 'loo' or 'elbo'"
    )


def make_value_and_grad(kernel: Kernel, data: ExpertData, cache=None,
                        objective: str = "marginal", extra=()):
    """``theta (float64 numpy) -> (float, float64 numpy grad)`` of
    ``objective`` (:func:`objective_fn`; ``extra`` is the ELBO's
    ``(active [m, p] numpy, sigma2)``): theta is cast to the stack's dtype
    and device, and the value and gradient come back to the host in one
    transfer.  ``cache``: as for :func:`batched_nll`, resident on the
    device across evaluations."""
    fn = objective_fn(objective)
    if objective == "elbo":
        active, sigma2 = extra
        extra = (torch.as_tensor(np.asarray(active, dtype=np.float64), dtype=data.x.dtype,
                                 device=data.x.device), sigma2)

    def vag(theta):
        t = torch.as_tensor(
            np.asarray(theta, dtype=np.float64), dtype=data.x.dtype,
            device=data.x.device,
        ).requires_grad_(True)
        value = fn(kernel, t, data, cache, *extra)
        (grad,) = torch.autograd.grad(value, t)
        host = torch.cat([value.detach()[None], grad]).to(torch.float64).cpu().numpy()
        return float(host[0]), host[1:]

    return vag
