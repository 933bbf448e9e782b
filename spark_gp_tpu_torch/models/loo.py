"""Per-expert leave-one-out moments (Rasmussen and Williams, section
5.4.2), the JAX package's ``models/loo.py``.

For an expert whose noise-augmented gram is ``K``, the exact LOO
predictive moments at fixed hyperparameters follow from ``K^-1``
(R&W eqs. 5.10-5.12):

    mu_{-i}     = y_i - [K^-1 y]_i / [K^-1]_ii
    sigma2_{-i} = 1 / [K^-1]_ii
    log p(y_i | y_{-i}) = -1/2 log(2 pi sigma2_{-i})
                          - (y_i - mu_{-i})^2 / (2 sigma2_{-i})

Each point conditions on its expert's other points, the structure the
training objective sums over.  One batched ``[E, s, s]`` inverse gives
every point's moments: K1 on a stack it takes, one batched Cholesky
otherwise (``ops/spd_linalg.batched_spd_inv_logdet``), whatever the
solver lane.  The gradient of :func:`batched_loo_nll` reaches K1's VJP
through ``diag(K^-1)`` and ``K^-1 y``; the backward launches nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack
from spark_gp_tpu_torch.models.aggregation import weighted_expert_sum
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import ExpertData, group_for_experts, ungroup


def loo_moments(kernel: Kernel, theta, x, y, mask, cache=None):
    """``[E, s, ...]`` expert stack -> per-slot ``(mu, var, log_density)``.

    A padded slot rides the identity embedding of the masked gram
    (``[K^-1]_ii = 1``, ``alpha_i = 0``): var 1, residual 0, finite and
    with zero theta-gradient; callers drop it by the mask.  ``cache`` is
    the fit's theta-invariant gram cache (``kernels/base.py``)."""
    kmat = masked_gram_stack(kernel, theta, x, mask, cache)
    kinv, _ = spd_linalg.batched_spd_inv_logdet(kmat)
    return moments_from_inverse(kinv, y * mask)


def moments_from_inverse(kinv, ym):
    """``(mu, var, log_density)`` from the ``[E, s, s]`` inverse grams and
    the masked targets ``ym [E, s]`` (R&W eqs. 5.10-5.12)."""
    alpha = torch.einsum("eij,ej->ei", kinv, ym)
    var = 1.0 / torch.diagonal(kinv, dim1=-2, dim2=-1)
    resid = alpha * var  # y_i - mu_{-i}
    mu = ym - resid
    log_density = -0.5 * (torch.log(2.0 * math.pi * var) + resid * resid / var)
    return mu, var, log_density


def batched_loo_nll(kernel: Kernel, theta, data: ExpertData, cache=None, weights=None):
    """The negative LOO log pseudo-likelihood over the expert stack
    (R&W eq. 5.13), the objective ``setObjective("loo")`` minimizes in
    place of the marginal NLL: the masked sum of the per-point log
    densities, negated; with the aggregation plane's per-expert
    ``weights`` (``models/aggregation.py``) each expert's sum enters at
    its weight."""
    _, _, log_density = loo_moments(kernel, theta, data.x, data.y, data.mask, cache)
    return -weighted_expert_sum(log_density * data.mask, weights)


def lanes_loo_nll(kernel: Kernel, thetas, data: ExpertData, cache=None, weights=None):
    """``[R]``: :func:`batched_loo_nll` of each lane's theta ``thetas [R, h]``,
    the R lanes' gram stacks through one batched inverse (one K1 launch
    over ``[R * E, s, s]`` where it applies): the device optimizer's
    multi-start objective."""
    r = thetas.shape[0]
    kmat = torch.stack([masked_gram_stack(kernel, thetas[i], data.x, data.mask, cache)
                        for i in range(r)])
    kinv, _ = spd_linalg.batched_spd_inv_logdet(kmat)
    e, s = kmat.shape[1], kmat.shape[-1]
    _, _, log_density = moments_from_inverse(kinv.reshape(r * e, s, s),
                                             (data.y * data.mask).repeat(r, 1))
    log_density = log_density.reshape(r, e, s)
    return torch.stack([-weighted_expert_sum(log_density[i] * data.mask, weights)
                        for i in range(r)])


@torch.no_grad()
def loo_diagnostics(kernel: Kernel, theta, x, y, dataset_size_for_expert: int,
                    dtype, device) -> dict:
    """Exact per-expert LOO diagnostics of ``(x [N, p], y [N])`` grouped
    as the fit groups them, in ``dtype`` on ``device``: the point-order
    arrays ``loo_mean``, ``loo_var`` and ``loo_log_density`` ``[N]``, and
    ``loo_rmse`` and ``loo_log_pseudo_likelihood`` (the sum of the log
    densities, R&W eq. 5.11)."""
    data = group_for_experts(x, y, dataset_size_for_expert, dtype=dtype, device=device)
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=dtype, device=device)
    moments = loo_moments(kernel, theta, data.x, data.y, data.mask)
    n = int(np.asarray(x).shape[0])
    loo_mean, loo_var, loo_logp = (ungroup(m.cpu().numpy(), n) for m in moments)
    resid = np.asarray(y, dtype=loo_mean.dtype) - loo_mean
    return {
        "loo_mean": loo_mean,
        "loo_var": loo_var,
        "loo_log_density": loo_logp,
        "loo_rmse": float(np.sqrt(np.mean(resid**2))),
        "loo_log_pseudo_likelihood": float(loo_logp.sum()),
    }
