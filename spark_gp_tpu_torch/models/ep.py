"""Expectation Propagation for binary GP classification (probit link), the
port of the JAX package's ``models/ep.py`` (host objective).

R&W ch. 3.6 as parallel EP: every site updates at once from the current
posterior marginals, damped, so a sweep is one batched factorization of
``B = I + S K S`` (``S = sqrt(tau~)``) over the ``[E, s, s]`` stack plus
elementwise cavity and moment arithmetic.  With ``M = S K`` the
marginals follow from ``B^-1`` (R&W eq. 3.66-3.68):

    Sigma = K - M^T B^-1 M,   diag Sigma = diag K - sum_a M_a. * (B^-1 M)_a.
    mu    = K nu~ - M^T B^-1 M nu~

``B^-1`` and ``log|B|`` come from ``spd_linalg.batched_spd_inv_logdet``:
on a CUDA float32 stack with ``s <= 512`` the hand-written kernel K1
(``csrc/spd_inv_logdet.cu``), else one batched Cholesky.

The sites ``(tau~, nu~) [E, s]`` are natural parameters carried between
objective evaluations (the Laplace latents' warm start).  The EP log
marginal likelihood is evaluated at the converged sites, held constant:
at an EP fixed point their sensitivities drop out of the gradient
(Seeger 2005), so autograd through ``log Z_EP`` in the gram gives R&W
eq. 3.80's gradient.  That pass runs through K1 and its VJP once.

Labels are {0, 1} at the API and {-1, +1} inside.  Padded slots carry
zero site precision: unit rows in B, nothing in any sum.

Counters: ``ep_fit_sites.sweeps`` (site sweeps, one host read each) and
``batched_neg_logz_ep.calls`` (objective evaluations).  On the exact lane
K1 runs once a sweep and once an evaluation, and once for the posterior
mean at the end of a fit.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack
from spark_gp_tpu_torch.models.aggregation import weighted_expert_sum
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import ExpertData

_LOG2PI = 1.8378770664093453


def _log_ndtr(z):
    """``log Phi(z)``, stable on both tails."""
    return torch.special.log_ndtr(z)


def _npdf_over_cdf(z):
    """``N(z; 0, 1) / Phi(z)`` as ``exp(log pdf - log cdf)``, stable for very
    negative ``z`` (where the ratio approaches ``-z``)."""
    log_pdf = -0.5 * (z * z + _LOG2PI)
    return torch.exp(log_pdf - _log_ndtr(z))


def _posterior_marginals(kmat, tau, nu):
    """``(diag Sigma, mu, B^-1, log|B|)`` of ``Sigma = (K^-1 + diag tau)^-1``
    and ``mu = Sigma nu`` through ``B = I + S K S`` (module doc), one
    batched inverse; differentiable in ``kmat`` (``tau`` and ``nu`` are
    constants of the objective)."""
    sq = torch.sqrt(tau)
    eye = torch.eye(kmat.shape[-1], dtype=kmat.dtype, device=kmat.device)
    b_mat = eye + sq[:, :, None] * kmat * sq[:, None, :]
    binv, logdet_b = spd_linalg.batched_spd_inv_logdet(b_mat)
    m_mat = sq[:, :, None] * kmat  # M = S K
    sigma_diag = torch.diagonal(kmat, dim1=-2, dim2=-1) - torch.sum(m_mat * (binv @ m_mat), dim=-2)
    mn = torch.einsum("eij,ej->ei", m_mat, nu)
    mu = torch.einsum("eij,ej->ei", kmat, nu) - torch.einsum(
        "eji,ej->ei", m_mat, torch.einsum("eij,ej->ei", binv, mn)
    )
    return sigma_diag, mu, binv, logdet_b


def _cavity(tau, nu, sigma_diag, mu):
    """Cavity parameters from the posterior marginals, with the JAX
    package's guards (a non-positive cavity precision from rounding is
    clipped far below any meaningful one); the site sweeps and ``log Z_EP``
    use this one form."""
    tau_cav = torch.clamp_min(1.0 / torch.clamp_min(sigma_diag, 1e-300) - tau, 1e-10)
    nu_cav = mu / torch.clamp_min(sigma_diag, 1e-300) - nu
    mu_cav = nu_cav / tau_cav
    s2_cav = 1.0 / tau_cav
    return tau_cav, nu_cav, mu_cav, s2_cav


def _site_update(y_pm, mask, tau, nu, sigma_diag, mu):
    """One parallel moment-matching pass (R&W Algorithm 3.5, lines 5-13,
    every site at once); the undamped new sites."""
    tau_cav, nu_cav, mu_cav, s2_cav = _cavity(tau, nu, sigma_diag, mu)
    # probit moments (R&W eq. 3.58)
    denom = torch.sqrt(1.0 + s2_cav)
    z = y_pm * mu_cav / denom
    ratio = _npdf_over_cdf(z)
    mu_hat = mu_cav + y_pm * s2_cav * ratio / denom
    s2_hat = s2_cav - s2_cav ** 2 * ratio / (1.0 + s2_cav) * (z + ratio)
    tau_new = torch.clamp_min(1.0 / torch.clamp_min(s2_hat, 1e-300) - tau_cav, 0.0)
    nu_new = mu_hat / torch.clamp_min(s2_hat, 1e-300) - nu_cav
    # a zero-precision site carries zero nu, as log Z_EP's guards assume
    nu_new = torch.where(tau_new > 0.0, nu_new, 0.0)
    return tau_new * mask, nu_new * mask


@torch.no_grad()
def ep_fit_sites(kmat, y_pm, mask, tau0, nu0, tol, max_sweeps: int = 60,
                 damping: float = 0.7):
    """Damped parallel EP from the sites ``(tau0, nu0)`` while the largest
    site change of the last sweep exceeds ``tol`` and fewer than
    ``max_sweeps`` have run (one host read a sweep); returns
    ``(tau, nu, sweeps)``."""
    tau, nu = tau0, nu0
    delta = torch.full((), torch.inf, dtype=kmat.dtype, device=kmat.device)
    sweeps = 0
    while sweeps < max_sweeps and bool(delta > tol):
        sigma_diag, mu, _, _ = _posterior_marginals(kmat, tau, nu)
        tau_new, nu_new = _site_update(y_pm, mask, tau, nu, sigma_diag, mu)
        tau_d = (1.0 - damping) * tau + damping * tau_new
        nu_d = (1.0 - damping) * nu + damping * nu_new
        delta = torch.maximum(torch.max(torch.abs(tau_d - tau)), torch.max(torch.abs(nu_d - nu)))
        tau, nu = tau_d, nu_d
        sweeps += 1
    ep_fit_sites.sweeps += sweeps
    return tau, nu, sweeps


#: site sweeps since the last reset
ep_fit_sites.sweeps = 0


def _ep_log_z(kmat, y_pm, mask, tau, nu):
    """``log Z_EP [E]`` at the sites ``(tau, nu)``, differentiable in
    ``kmat``: R&W eq. 3.65 in natural parameters (the JAX package's
    ``_ep_log_z`` derives it), with ``1/2 log|B|`` from the batched
    inverse's log-determinant and the quadratic term ``u^T B^-1 u``,
    ``u = nu / sqrt(tau)``."""
    sigma_diag, mu, binv, logdet_b = _posterior_marginals(kmat, tau, nu)
    _, _, mu_cav, s2_cav = _cavity(tau, nu, sigma_diag, mu)
    z = y_pm * mu_cav / torch.sqrt(1.0 + s2_cav)
    term_sites = torch.sum(_log_ndtr(z) * mask, dim=-1)

    pos = tau > 0.0
    r = tau * s2_cav
    nu2_over_tau = torch.where(pos, nu * nu / torch.where(pos, tau, 1.0), 0.0)
    term_norm = 0.5 * torch.sum(mask * torch.log1p(r), dim=-1)
    term_match = 0.5 * torch.sum(
        mask * (tau * mu_cav ** 2 - 2.0 * mu_cav * nu + nu2_over_tau) / (1.0 + r), dim=-1
    )
    u = torch.where(pos, nu / torch.sqrt(torch.where(pos, tau, 1.0)), 0.0)
    quad = 0.5 * torch.einsum("ei,eij,ej->e", u, binv, u)
    return term_sites + term_norm + term_match - 0.5 * logdet_b - quad


def batched_neg_logz_ep(kernel: Kernel, tol, theta, data: ExpertData, sites0, weights=None):
    """``(-sum_e log Z_EP, its gradient in theta, (tau, nu))`` over the
    expert stack; ``theta`` is a tensor on the stack's device.  The sites
    run to convergence from ``sites0`` on the detached gram and are held
    constant in the differentiated ``log Z_EP`` (module doc).  ``weights``
    (``[E]``, ``models/aggregation.py``) weights each expert's ``log
    Z_EP``; ``None`` keeps the plain sum."""
    batched_neg_logz_ep.calls += 1
    tau0, nu0 = sites0
    y_pm = (2.0 * data.y - 1.0) * data.mask  # {0,1} -> {-1,+1}, masked
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        kmat = masked_gram_stack(kernel, th, data.x, data.mask)
        tau, nu, _ = ep_fit_sites(kmat.detach(), y_pm, data.mask, tau0, nu0, tol)
        value = -weighted_expert_sum(_ep_log_z(kmat, y_pm, data.mask, tau, nu), weights)
        (grad,) = torch.autograd.grad(value, th)
    return value.detach(), grad, (tau, nu)


#: objective evaluations since the last reset
batched_neg_logz_ep.calls = 0


def make_ep_objective(kernel: Kernel, data: ExpertData, tol):
    """``(theta float64 numpy, (tau, nu)) -> (float, float64 numpy grad,
    (tau, nu))`` for the host optimizer: theta is cast to the stack's
    dtype and device, the value and gradient come back to the host in one
    transfer, and the sites stay on the device."""

    def objective(theta, sites):
        t = torch.as_tensor(
            np.asarray(theta, dtype=np.float64), dtype=data.x.dtype, device=data.x.device
        )
        value, grad, sites_new = batched_neg_logz_ep(kernel, tol, t, data, sites)
        host = torch.cat([value[None], grad]).to(torch.float64).cpu().numpy()
        return float(host[0]), host[1:], sites_new

    return objective


@torch.no_grad()
def ep_posterior_mean(kernel: Kernel, theta, x, mask, tau, nu):
    """The posterior latent mean ``mu [E, s]`` at ``(theta, sites)`` (zero
    on padded slots): the PPA targets, as the Laplace mode is the binary
    classifier's."""
    kmat = masked_gram_stack(kernel, theta, x, mask)
    _, mu, _, _ = _posterior_marginals(kmat, tau, nu)
    return mu * mask
