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
"""

from __future__ import annotations

import math

import torch

from spark_gp_tpu_torch.kernels.base import Kernel
from spark_gp_tpu_torch.ops.linalg import cholesky
from spark_gp_tpu_torch.parallel.experts import ExpertData


def batched_elbo_nll(kernel: Kernel, theta, data: ExpertData, active, sigma2):
    """The negative collapsed ELBO over the expert stack (GPflow's SGPR
    form: ``A = L^-1 K_mn / sigma``, ``B = I + A A^T``).  ``active`` is the
    fixed ``[m, p]`` inducing set in the stack's dtype and device,
    ``sigma2`` the Gaussian noise; padded slots are masked out of every
    sum."""
    e, _, p = data.x.shape
    m = active.shape[0]
    # a Python float: no host-to-device copy, so the objective can run
    # inside a captured CUDA graph (the device optimizer)
    sigma2 = float(sigma2)
    sigma = math.sqrt(sigma2)
    eye = torch.eye(m, dtype=data.x.dtype, device=data.x.device)

    kmm = kernel.gram(theta, active)
    jitter = 1e-6 * torch.mean(torch.diagonal(kmm))
    chol_l = cholesky(kmm + jitter * eye)

    mask = data.mask
    kme = kernel.cross(theta, active.expand(e, m, p), data.x) * mask[:, None, :]  # [E, m, s]
    ae = torch.linalg.solve_triangular(chol_l, kme, upper=False) / sigma  # whitened
    yem = data.y * mask
    aat = torch.einsum("eis,ejs->ij", ae, ae)
    ay = torch.einsum("eis,es->i", ae, yem / sigma)
    yy = torch.sum(yem * yem)
    tr_knn = torch.sum(kernel.self_diag(theta, data.x) * mask)
    n = torch.sum(mask)

    chol_b = cholesky(eye + aat)
    c = torch.linalg.solve_triangular(chol_b, ay[:, None], upper=False)[:, 0]
    log_det_b = 2.0 * torch.sum(torch.log(torch.diagonal(chol_b)))
    elbo = (
        -0.5 * n * math.log(2.0 * math.pi * sigma2)
        - 0.5 * log_det_b
        - 0.5 * yy / sigma2
        + 0.5 * torch.sum(c * c)
        - 0.5 * tr_knn / sigma2
        # tr(Q_nn) / (2 sigma2); the diagonal's sum, as torch.trace's backward
        # reads its size on the host (no capture in a CUDA graph)
        + 0.5 * torch.diagonal(aat).sum()
    )
    return -elbo
