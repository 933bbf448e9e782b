"""Titsias' collapsed SGPR bound, the variational training objective
(``setObjective("elbo")``), the JAX package's ``models/sgpr.py``.

Titsias, *Variational Learning of Inducing Variables in Sparse GPs*,
AISTATS 2009, eq. 9:

    ELBO = log N(y | 0, Q_nn + sigma2 I) - 1/(2 sigma2) tr(K_nn - Q_nn)

with ``Q_nn = K_nm K_mm^-1 K_mn`` over the inducing (active) set, which
the fit selects before the optimization and holds fixed.  The model
trained is the same projected-process model the PPA build makes; only
the hyperparameters' objective changes.  Through the estimator the
kernel is the noise-augmented model kernel (user kernel + ``sigma2 *
Eye``): the Eye term adds a ``sigma2`` nugget to ``K_mm``, nothing to
``K_mn`` and a constant to the trace term.

Per evaluation: the ``[m, m]`` Cholesky of ``K_mm``, the whitened cross
kernels ``a_e = L^-1 K_me / sigma`` of every expert, and the Cholesky of
``B = I + sum_e a_e a_e^T``.  The statistics are whitened before they
are squared: ``L^-1 U1 L^-T`` from the PPA's ``U1`` squares the normal
equations' conditioning, and in float32 its rounding exceeds ``B``'s
unit eigenvalue floor, so ``chol(B)`` turns NaN.  The Choleskys and
triangular solves are ``torch.linalg`` calls; no hand-written kernel
runs here.

The bound is split in two (:func:`elbo_sums`, :func:`elbo_from_sums`):
sums over the experts (``A A^T``, ``A y``, ``y.y``, the point count and
the residual trace), and a function of the sums alone.  Over a mesh each
rank sums its own experts and the sums are all-reduced
(``models/likelihood.py``).  The trace term is summed as one residual
``sum_j (k_jj - q_jj)`` per point, not as ``tr K_nn - tr Q_nn``: where
the two traces are large and nearly cancel, in float32 their difference
carries the rounding of both large sums into the bound, where each
point's difference is small before it is summed.  The sums are taken in
float64 whatever the stack's dtype, as the PPA statistics they whiten are
(``models/ppa.kmn_stats``): in float32 the cross kernel, ``K_mm``'s factor
and the whitening left the bound's value and gradient 1e-5 .. 6e-5 and
1e-4 .. 6e-4 from float64 on the Synthetics config on the CPU, with or
without the residual trace (``tests/test_torch_objectives.py``).  The
bound and its gradient come back in the stack's dtype; the precision
lanes do not reach the ELBO (float64 grams are always strict).
"""

from __future__ import annotations

import math

import torch

from spark_gp_tpu_torch.kernels.base import Kernel
from spark_gp_tpu_torch.ops.linalg import cholesky
from spark_gp_tpu_torch.parallel.experts import ExpertData


def elbo_sums(kernel: Kernel, theta, data: ExpertData, active, sigma2):
    """The bound's sums over the experts of ``data``: ``(aat [m, m], ay [m],
    yy, resid, n)`` with ``A = L^-1 K_mn / sigma`` (GPflow's SGPR form),
    ``aat = A A^T``, ``ay = A y / sigma``, ``yy = y.y``, ``resid = sum_j
    (k_jj - sigma2 sum_i A_ij^2)`` (``tr(K_nn - Q_nn)`` point by point) and
    ``n`` the points, in float64 whatever the stack's dtype.  ``active``
    is the fixed ``[m, p]`` inducing set on the stack's device, ``sigma2``
    the Gaussian noise; padded slots are masked out of every sum.  Each is
    linear in the experts, so the sums of blocks are the sums of the
    stack."""
    e, _, p = data.x.shape
    m = active.shape[0]
    # a Python float: no host-to-device copy, so the objective can run
    # inside a captured CUDA graph (the device optimizer)
    sigma2 = float(sigma2)
    sigma = math.sqrt(sigma2)
    f64 = torch.float64
    theta, active = theta.to(f64), active.to(f64)
    x, mask = data.x.to(f64), data.mask.to(f64)
    eye = torch.eye(m, dtype=f64, device=x.device)

    kmm = kernel.gram(theta, active)
    jitter = 1e-6 * torch.mean(torch.diagonal(kmm))
    chol_l = cholesky(kmm + jitter * eye)

    kme = kernel.cross(theta, active.expand(e, m, p), x) * mask[:, None, :]  # [E, m, s]
    ae = torch.linalg.solve_triangular(chol_l, kme, upper=False) / sigma  # whitened
    yem = data.y.to(f64) * mask
    aat = torch.einsum("eis,ejs->ij", ae, ae)
    ay = torch.einsum("eis,es->i", ae, yem / sigma)
    yy = torch.sum(yem * yem)
    resid = torch.sum((kernel.self_diag(theta, x) - sigma2 * torch.sum(ae * ae, dim=1)) * mask)
    return aat, ay, yy, resid, torch.sum(mask)


def elbo_from_sums(aat, ay, yy, resid, n, sigma2):
    """The negative collapsed ELBO from the sums of :func:`elbo_sums`
    (over a stack, or all-reduced over a mesh)."""
    sigma2 = float(sigma2)
    m = aat.shape[0]
    chol_b = cholesky(torch.eye(m, dtype=aat.dtype, device=aat.device) + aat)
    c = torch.linalg.solve_triangular(chol_b, ay[:, None], upper=False)[:, 0]
    log_det_b = 2.0 * torch.sum(torch.log(torch.diagonal(chol_b)))
    elbo = (
        -0.5 * n * math.log(2.0 * math.pi * sigma2)
        - 0.5 * log_det_b
        - 0.5 * yy / sigma2
        + 0.5 * torch.sum(c * c)
        - 0.5 * resid / sigma2
    )
    return -elbo


def flatten_sums(sums) -> torch.Tensor:
    """The sums of :func:`elbo_sums` as one vector (the payload of one
    all-reduce); :func:`unflatten_sums` inverts it."""
    return torch.cat([s.reshape(-1) for s in sums])


def unflatten_sums(flat: torch.Tensor, m: int):
    """``(aat, ay, yy, resid, n)`` of a :func:`flatten_sums` vector."""
    aat, ay = flat[:m * m].reshape(m, m), flat[m * m:m * m + m]
    yy, resid, n = flat[m * m + m], flat[m * m + m + 1], flat[m * m + m + 2]
    return aat, ay, yy, resid, n


def batched_elbo_nll(kernel: Kernel, theta, data: ExpertData, active, sigma2):
    """The negative collapsed ELBO over the expert stack:
    :func:`elbo_from_sums` of :func:`elbo_sums`."""
    return elbo_from_sums(*elbo_sums(kernel, theta, data, active, sigma2), sigma2)


def elbo_value_and_grad(kernel: Kernel, thetas, data: ExpertData, active, sigma2,
                        reduce=None):
    """``(values [R], grads [R, h])`` of the negative ELBO at each lane's
    theta in two passes: each lane's sums over ``data`` (:func:`elbo_sums`),
    reduced by ``reduce`` (a mesh's all-reduce: over a mesh ``data`` is this
    rank's block; ``None`` keeps them), the bound of the reduced sums and
    its cotangent on them, then the sums' vector-Jacobian product with that
    cotangent, reduced again: ``grad F(sum_r S_r) = sum_r VJP_r(dF/dS)``.
    ``reduce`` is never differentiated; the two reductions are the
    evaluation's only collectives.  The values and gradients are in
    ``thetas``' dtype (the sums in float64)."""
    reduce = reduce if reduce is not None else (lambda t: t)
    m = active.shape[0]
    with torch.enable_grad():
        t = thetas.detach().requires_grad_(True)
        local = torch.stack([flatten_sums(elbo_sums(kernel, t[r], data, active, sigma2))
                             for r in range(t.shape[0])])
        summed = reduce(local.detach()).requires_grad_(True)
        values = torch.stack([elbo_from_sums(*unflatten_sums(summed[r], m), sigma2)
                              for r in range(t.shape[0])])
        (cot,) = torch.autograd.grad(values.sum(), summed)
        (grad,) = torch.autograd.grad(local, t, grad_outputs=cot)
    return values.detach().to(thetas.dtype), reduce(grad)
