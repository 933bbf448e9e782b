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

The device fits (:func:`fit_gpc_ep_device` and its batched multi-start,
the JAX package's) run the sweeps inside the device optimizer's captured
step (:class:`EPLanes`, a latent objective of ``optimize/lbfgs_device.py``
whose ``aux`` is the site pair): a step holds ``k`` damped sweeps over
every lane's ``[R * E, s, s]`` B stack, one K1 launch each, a lane's
sweeps going on while the largest site change over all of its experts
exceeds ``tol`` (the JAX ``ep_fit_sites`` under its multi-start ``vmap``),
at most 60 a trial, carried across replays; then the gradient pass at the
sites reached.  EP has no iterative lane: its B systems go through K1 (or
the Cholesky) on every solver lane, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack
from spark_gp_tpu_torch.models.aggregation import weighted_expert_sum
from spark_gp_tpu_torch.models.laplace_device import (
    LaplaceLanes,
    fit_latent_device,
    fit_latent_device_multistart,
)
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


#: the site sweeps' damping and their cap a site fit (the JAX defaults)
DAMPING = 0.7
MAX_SWEEPS = 60


def _damped_sweep(kmat, y_pm, mask, tau, nu, damping: float = DAMPING):
    """One damped parallel sweep: the new sites ``(tau_d, nu_d)``, one
    batched inverse of B (K1 on the card)."""
    sigma_diag, mu, _, _ = _posterior_marginals(kmat, tau, nu)
    tau_new, nu_new = _site_update(y_pm, mask, tau, nu, sigma_diag, mu)
    return (1.0 - damping) * tau + damping * tau_new, (1.0 - damping) * nu + damping * nu_new


@torch.no_grad()
def ep_fit_sites(kmat, y_pm, mask, tau0, nu0, tol, max_sweeps: int = MAX_SWEEPS,
                 damping: float = DAMPING):
    """Damped parallel EP from the sites ``(tau0, nu0)`` while the largest
    site change of the last sweep exceeds ``tol`` and fewer than
    ``max_sweeps`` have run (one host read a sweep); returns
    ``(tau, nu, sweeps)``."""
    tau, nu = tau0, nu0
    delta = torch.full((), torch.inf, dtype=kmat.dtype, device=kmat.device)
    sweeps = 0
    while sweeps < max_sweeps and bool(delta > tol):
        tau_d, nu_d = _damped_sweep(kmat, y_pm, mask, tau, nu, damping)
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


def make_sharded_ep_objective(kernel: Kernel, data: ExpertData, tol, mesh):
    """:func:`make_ep_objective` over ``mesh``: this rank's block, its
    sites local, the value and gradient all-reduced
    (``parallel/mesh.allreduced_objective``)."""
    from spark_gp_tpu_torch.parallel.mesh import allreduced_objective

    return allreduced_objective(make_ep_objective(kernel, data, tol), mesh)


@torch.no_grad()
def ep_posterior_mean(kernel: Kernel, theta, x, mask, tau, nu):
    """The posterior latent mean ``mu [E, s]`` at ``(theta, sites)`` (zero
    on padded slots): the PPA targets, as the Laplace mode is the binary
    classifier's."""
    kmat = masked_gram_stack(kernel, theta, x, mask)
    _, mu, _, _ = _posterior_marginals(kmat, tau, nu)
    return mu * mask


# --- the device fits (``models/laplace_device.py``'s drivers) ---------------------------


class EPLanes(LaplaceLanes):
    """R lanes of EP's objective for the device optimizer (module doc):
    ``aux`` is the ``[R, E, s, 2]`` site pair ``(tau, nu)``; a trial carries
    its sites, the lane's last largest site change and its sweep count
    (``carry_fields``) across steps.  ``newton_k`` is the sweeps of a step;
    a gradient pass is one K1 call.  No gram cache: EP's sweeps have no
    cached-gram path."""

    family = "ep"
    passes = 1
    carry_fields = ("nt_f", "nt_delta", "nt_sweeps")

    def __init__(self, kernel: Kernel, data: ExpertData, tol, max_sweeps: int = MAX_SWEEPS,
                 damping: float = DAMPING) -> None:
        super().__init__(kernel, data.x, data.y, data.mask, tol, None)
        self.max_sweeps, self.damping = int(max_sweeps), float(damping)

    def aux0(self, r: int):
        """Zero sites ``[r, E, s, 2]``."""
        return torch.zeros((r,) + tuple(self.y.shape) + (2,), dtype=self.x.dtype,
                           device=self.x.device)

    def reset(self, aux) -> Dict[str, torch.Tensor]:
        """A site fit from ``aux``: no change seen yet (``inf``), no sweep."""
        r = aux.shape[0]
        return {"nt_f": aux.clone(),
                "nt_delta": torch.full((r,), torch.inf, dtype=aux.dtype, device=aux.device),
                "nt_sweeps": torch.zeros((r,), dtype=torch.int32, device=aux.device)}

    def _going(self, delta, sweeps):
        return (delta > self.tol) & (sweeps < self.max_sweeps)

    def _sweep(self, kmat, y_pm, mask, tau, nu, delta, sweeps, going):
        """One damped sweep of every lane's stack, kept for the lanes in
        ``going``; a lane's change is the largest over all its experts."""
        r = going.shape[0]
        tau_d, nu_d = _damped_sweep(kmat, y_pm, mask, tau, nu, self.damping)
        change = torch.maximum((tau_d - tau).abs().reshape(r, -1).amax(-1),
                               (nu_d - nu).abs().reshape(r, -1).amax(-1))
        keep = going.repeat_interleave(tau.shape[0] // r)[:, None]
        return (torch.where(keep, tau_d, tau), torch.where(keep, nu_d, nu),
                torch.where(going, change, delta), sweeps + going.to(torch.int32))

    def _sites(self, aux):
        r, e, s = aux.shape[:3]
        return aux[..., 0].reshape(r * e, s), aux[..., 1].reshape(r * e, s)

    def _trial(self, thetas, carry, run):
        r, e, s = carry["nt_f"].shape[:3]
        kmat = self.lane_grams(thetas)
        y, mask = self.lane_targets(r)
        y_pm = (2.0 * y - 1.0) * mask
        tau, nu = self._sites(carry["nt_f"])
        delta, sweeps = carry["nt_delta"], carry["nt_sweeps"]
        worked = torch.zeros((), dtype=torch.int32, device=tau.device)
        for _ in range(self.newton_k):
            going = self._going(delta, sweeps) & run
            worked = worked + going.any().to(torch.int32)
            tau, nu, delta, sweeps = self._sweep(kmat, y_pm, mask, tau, nu, delta, sweeps, going)
        finished = ~(self._going(delta, sweeps) & run)
        values, grads = self._gradient_pass(thetas, tau, nu)
        sites = torch.stack([tau, nu], dim=-1).reshape(r, e, s, 2)
        return values, grads, {"nt_f": sites, "nt_delta": delta, "nt_sweeps": sweeps}, \
            finished, worked

    def _evaluate(self, thetas, aux):
        """One whole evaluation, eagerly: masked sweeps of every lane until
        none goes on (one host read a sweep), then the gradient pass."""
        r, e, s = aux.shape[:3]
        kmat = self.lane_grams(thetas)
        y, mask = self.lane_targets(r)
        y_pm = (2.0 * y - 1.0) * mask
        tau, nu = self._sites(aux)
        start = self.reset(aux)
        delta, sweeps = start["nt_delta"], start["nt_sweeps"]
        while True:
            going = self._going(delta, sweeps)
            if not bool(going.any()):
                break
            self.eager_iterations += 1
            tau, nu, delta, sweeps = self._sweep(kmat, y_pm, mask, tau, nu, delta, sweeps, going)
        self.eager_evaluations += 1
        values, grads = self._gradient_pass(thetas, tau, nu)
        return values, grads, torch.stack([tau, nu], dim=-1).reshape(r, e, s, 2)

    def _gradient_pass(self, thetas, tau, nu):
        """``(-sum_e log Z_EP [R], its gradient [R, h])`` at the sites, by
        autograd through ``log Z_EP`` in every lane's gram (one K1 call)."""
        r = thetas.shape[0]
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            y, mask = self.lane_targets(r)
            log_z = _ep_log_z(self.lane_grams(th, grad=True), (2.0 * y - 1.0) * mask, mask,
                              tau, nu)
            values = -log_z.reshape(r, -1).sum(-1)
            (grad,) = torch.autograd.grad(values.sum(), th)
        return values.detach(), grad


def _lanes_posterior_mean(lanes: EPLanes, theta, sites):
    """The latent posterior mean ``[E, s]`` at ``theta`` and one lane's
    sites ``[E, s, 2]``, on the device (one K1 call)."""
    return ep_posterior_mean(lanes.kernel, theta, lanes.x, lanes.mask, sites[..., 0],
                             sites[..., 1])


def fit_gpc_ep_device(kernel: Kernel, tol, log_space: bool, theta0, lower, upper,
                      data: ExpertData, max_iter: int, capture: bool = True, loop_metrics=None,
                      mesh=None):
    """The single-start device fit of the EP classifier from zero sites (JAX
    ``fit_gpc_ep_device``): ``(theta, (tau, nu), latent_mu [E, s], nll,
    n_iter, n_fev, stalled)`` as device tensors, the latent mean the PPA
    targets at theta and the sites of the last accepted iterate.  With
    ``mesh`` (JAX ``fit_gpc_ep_device_sharded``), ``data`` is this rank's
    block: its site pair stays on the rank, each rank's sweeps stop on its
    own experts' largest change (as each JAX device's do), and the sites
    and latent mean returned are the block's."""
    lanes = EPLanes(kernel, data, tol)
    theta, sites, f, n_iter, n_fev, stalled = fit_latent_device(
        lanes, log_space, theta0, lower, upper, max_iter, tol, capture=capture,
        loop_metrics=loop_metrics, mesh=mesh)
    return (theta, (sites[..., 0], sites[..., 1]), _lanes_posterior_mean(lanes, theta, sites), f,
            n_iter, n_fev, stalled)


def fit_gpc_ep_device_multistart(kernel: Kernel, tol, log_space: bool, theta0_batch, lower,
                                 upper, data: ExpertData, max_iter: int, loop_metrics=None,
                                 mesh=None):
    """R restarts as one device loop, the site pairs riding per lane (JAX
    ``fit_gpc_ep_device_multistart``): ``(theta_best, latent_mu_best, nll_best,
    n_iter, n_fev, stalled, f_all [R], best)``.  ``mesh``: as for
    :func:`fit_gpc_ep_device`."""
    lanes = EPLanes(kernel, data, tol)
    theta, sites, f, n_iter, n_fev, stalled, f_all, best = fit_latent_device_multistart(
        lanes, log_space, theta0_batch, lower, upper, max_iter, tol, loop_metrics=loop_metrics,
        mesh=mesh)
    return (theta, _lanes_posterior_mean(lanes, theta, sites), f, n_iter, n_fev, stalled, f_all,
            best)
