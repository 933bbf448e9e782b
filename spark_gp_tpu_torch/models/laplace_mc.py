"""Laplace approximation for multiclass GP classification (softmax link),
the port of the JAX package's ``models/laplace_mc.py``.

One latent function per class under a shared GP prior, coupled through
the softmax likelihood (R&W ch. 3.5).  With ``pi = softmax(f)``,
``D_c = diag(pi_c)`` and the softmax Hessian ``W = D - Pi Pi^T``, each
Newton step (R&W Algorithm 3.3, over the expert stack) solves
``(I + W K_blk)^-1 b`` with per-class ``s x s`` factorizations only:

    E_c = sqrt(D_c) (I + sqrt(D_c) K sqrt(D_c))^-1 sqrt(D_c)
    M   = chol(sum_c E_c)
    a_c = b_c - E_c K b_c + E_c M^-T M^-1 sum_c' (E_c' K b_c')
    f'  = K a

and the normalizer's log-determinant splits the same way:

    log det(I + K_blk W) = sum_c log det(B_c) + 2 sum log diag M

Every ``B_c`` is inverted in one batched pass over the ``[E * C, s, s]``
stack: on a CUDA float32 stack with ``s <= 512`` the hand-written kernel
of ``ops/spd_linalg.py`` (K1), on the CPU one batched Cholesky
(``spd_linalg.batched_spd_inv_logdet``).  On the
iterative lanes the Newton step is one CG solve on the factored operator
``I + S^T K_blk S`` and the log-determinant its SLQ estimate
(``ops/iterative.py``).

The gradient is autograd's through one Newton step: the mode is found
without gradients, then one differentiable step is taken from it.  The
Newton map has zero derivative in ``f`` at the mode, so the step's output
carries the implicit derivative of the mode in theta, and ``-log Z``
evaluated with the determinants at the stepped iterate has the full
gradient (the binary path's s2/s3 terms included).  The autograd graph
runs through K1 twice (the step's ``B_c^-1`` and the determinants'),
backward by K1's own VJP.

Counters: ``laplace_mc_mode.iterations`` (Newton iterations) and
``batched_neg_logz_mc.calls`` (objective evaluations).  On the exact lane
K1 runs once a Newton iteration and twice an evaluation.  The device fits
(:func:`fit_gpc_mc_device` and its variants, ``models/laplace_device.py``)
run the same Newton step and gradient inside the device optimizer's
captured step, every lane's B_c stacks one K1 launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack
from spark_gp_tpu_torch.models.aggregation import weighted_expert_sum
from spark_gp_tpu_torch.models.laplace_device import (
    LaplaceLanes,
    fit_latent_device,
    fit_latent_device_checkpointed,
    fit_latent_device_multistart,
    newton_running,
    newton_start,
    newton_update,
)
from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.ops.linalg import chol_solve, cholesky


class McStep(NamedTuple):
    a: torch.Tensor              # [E, s, C]
    f_new: torch.Tensor          # [E, s, C]
    half_logdet_b: torch.Tensor  # [E] = sum_c log diag chol(B_c)
    half_logdet_m: torch.Tensor  # [E] = sum log diag chol(sum_c E_c)


def _softmax_terms(y1h, mask, f):
    """``(pi, sqrt(pi), b)``: the masked softmax, its square root and the
    Newton right-hand side ``b = W f + (y - pi)`` row by row."""
    pi = torch.softmax(f, dim=-1) * mask[..., None]
    # double-where sqrt guard: pi is exactly 0 at padded rows and at
    # underflowed entries, where sqrt's derivative is infinite and the
    # gradient would turn 0 * inf into NaN
    pi_pos = pi > 0.0
    sqd = torch.where(pi_pos, torch.sqrt(torch.where(pi_pos, pi, 1.0)), 0.0)
    pif_sum = torch.sum(pi * f, dim=-1, keepdim=True)
    b_vec = (pi * f - pi * pif_sum + (y1h - pi)) * mask[..., None]
    return pi, sqd, b_vec


def _mc_newton_quantities(kmat, y1h, mask, f, with_logdet: bool = True) -> McStep:
    """One Newton step from latent ``f`` for the whole ``[E, s, C]`` stack,
    with the two half-log-determinants of the Laplace normalizer at
    ``f``; differentiable in ``kmat`` and ``f``.  Padding adds nothing:
    ``sqrt(D_c)`` is masked, so ``B_c`` has unit padded rows, and
    ``sum_c E_c`` gets an identity pad block.  ``with_logdet=False``
    skips the iterative lane's SLQ log-det, which a Newton step does not
    read (the half-log-determinants are then None on that lane)."""
    pi, sqd, b_vec = _softmax_terms(y1h, mask, f)
    if it_ops.resolve_solver(kmat.shape[-1], num_experts=kmat.shape[0],
                             itemsize=kmat.element_size()) in ("iterative", "matfree"):
        return _mc_newton_quantities_iter(kmat, mask, f, pi, sqd, b_vec, with_logdet)

    # B_c = I + sqrt(D_c) K sqrt(D_c), batched over (expert, class)
    eye = torch.eye(kmat.shape[-1], dtype=kmat.dtype, device=kmat.device)
    sq_ec = sqd.movedim(-1, 1)  # [E, C, s]
    b_mats = eye + sq_ec[..., :, None] * kmat[:, None] * sq_ec[..., None, :]
    binv, logdet_b = spd_linalg.batched_spd_inv_logdet(b_mats)  # [E, C, s, s], [E, C]

    # E_c = sqrt(D_c) B_c^-1 sqrt(D_c); M = chol(sum_c E_c + pad identity)
    e_mats = sq_ec[..., :, None] * binv * sq_ec[..., None, :]
    sum_e = torch.sum(e_mats, dim=1) + eye * (1.0 - mask[:, :, None])
    m_chol = cholesky(sum_e)
    half_logdet_m = torch.sum(
        torch.log(torch.diagonal(m_chol, dim1=-2, dim2=-1)) * mask, dim=-1
    )

    kb_ec = torch.einsum("est,etc->ecs", kmat, b_vec)  # K b_c, [E, C, s]
    c_ec = sq_ec * torch.einsum("ecst,ect->ecs", binv, sq_ec * kb_ec)  # E_c K b_c
    u = chol_solve(m_chol, torch.sum(c_ec, dim=1))  # (sum_c E_c)^-1 sum_c c_c
    eu_ec = sq_ec * torch.einsum("ecst,ect->ecs", binv, sq_ec * u[:, None, :])
    a = (b_vec.movedim(-1, 1) - c_ec + eu_ec).movedim(1, -1)
    f_new = torch.einsum("est,etc->esc", kmat, a)
    return McStep(a, f_new, 0.5 * torch.sum(logdet_b, dim=1), half_logdet_m)


def _mc_newton_quantities_iter(kmat, mask, f, pi, sqd, b_vec, with_logdet) -> McStep:
    """The iterative lanes' Newton step: one factored system, no per-class
    factorization.  The softmax Hessian has the root ``W = S S^T`` with
    ``S_cd = sqrt(pi_c) delta_cd - pi_c sqrt(pi_d)`` row by row (zero on
    padded rows), so by push-through

        a = b - S (I + S^T K_blk S)^-1 S^T K_blk b

    by CG on the factored operator (``ops.iterative.factored_solve``), and
    by Sylvester ``log det(I + K_blk W) = log det(I + S^T K_blk S)``
    (``factored_logdet``), returned in ``half_logdet_b`` with
    ``half_logdet_m = 0``."""
    eye_c = torch.eye(pi.shape[-1], dtype=kmat.dtype, device=kmat.device)
    smat = sqd[..., :, None] * eye_c - pi[..., :, None] * sqd[..., None, :]
    kb = torch.einsum("est,etc->esc", kmat, b_vec)
    skb = torch.einsum("esdc,esd->esc", smat, kb)
    v = it_ops.factored_solve(kmat, smat, skb)
    a = b_vec - torch.einsum("escd,esd->esc", smat, v)
    f_new = torch.einsum("est,etc->esc", kmat, a)
    if not with_logdet:
        return McStep(a, f_new, None, None)
    half_logdet = 0.5 * it_ops.factored_logdet(kmat, smat)
    return McStep(a, f_new, half_logdet, torch.zeros_like(half_logdet))


def _mc_log_lik(f, y1h, mask):
    """``sum_i mask_i (y_i . f_i - logsumexp_c f_ic)`` per expert."""
    return torch.sum(
        (torch.sum(y1h * f, dim=-1) - torch.logsumexp(f, dim=-1)) * mask, dim=-1
    )


def _mc_objective(a, f_new, y1h, mask):
    """The penalized inner objective ``-a^T f / 2 + log p(y|f)`` per
    expert, the multiclass twin of the binary acceptance objective."""
    return -0.5 * torch.sum(a * f_new, dim=(-2, -1)) + _mc_log_lik(f_new, y1h, mask)


def _mc_proposal(kmat, y1h, mask, f):
    """``(a, K a)`` of one Newton step from latent ``f`` (no log-det)."""
    stp = _mc_newton_quantities(kmat, y1h, mask, f, with_logdet=False)
    return stp.a, stp.f_new


@torch.no_grad()
def laplace_mc_mode(kmat, y1h, mask, f0, tol):
    """The softmax-Laplace Newton loop with per-expert step halving over
    the whole stack; returns ``(f_modes [E, s, C], objective [E])``.

    Acceptance and termination are the binary loop's (and the JAX
    ``while_loop``'s, ``laplace_device.newton_update``): a candidate is
    accepted iff its objective beats ``old``, else that expert's step
    halves; an expert runs while ``|old - new| > tol and step > tol``.
    Deciding whether to go on is one host read an iteration."""
    f = f0
    old, new, step = newton_start(f0)
    while True:
        run = newton_running(old, new, step, tol)
        if not bool(run.any()):
            return f, new
        laplace_mc_mode.iterations += 1
        f, old, new, step = newton_update(_mc_proposal, _mc_objective, kmat, y1h, mask, f, old,
                                          new, step, run)


#: Newton iterations since the last reset
laplace_mc_mode.iterations = 0


def batched_neg_logz_mc(kernel: Kernel, tol, theta, x, y1h, mask, f0, cache=None,
                        weights=None):
    """``(-sum_e log Z_e, its gradient in theta, f_modes [E, s, C])`` over
    the stack (module doc); ``theta`` is a tensor on the stack's device.
    The mode is found without gradients, then one differentiable Newton
    step is taken from it and the determinants are evaluated at the
    stepped iterate.  With the fit's gram ``cache`` (``kernels/base.py``)
    the gram is built, and differentiated, from it.  ``weights`` (``[E]``,
    ``models/aggregation.py``) weights each expert's evidence; ``None``
    keeps the plain sum."""
    batched_neg_logz_mc.calls += 1
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        kmat = masked_gram_stack(kernel, th, x, mask, cache)
        f_hat, _ = laplace_mc_mode(kmat.detach(), y1h, mask, f0, tol)
        value = -weighted_expert_sum(_log_z_at_mode(kmat, y1h, mask, f_hat), weights)
        (grad,) = torch.autograd.grad(value, th)
    return value.detach(), grad, f_hat


def _log_z_at_mode(kmat, y1h, mask, f_hat):
    """``log Z_e`` ``[B]`` at the mode ``f_hat``, differentiable in the
    gram ``kmat``: one Newton step from the mode, the determinants at the
    stepped iterate (module doc), two K1 calls on the exact lane."""
    stp = _mc_newton_quantities(kmat, y1h, mask, f_hat, with_logdet=False)
    # the determinants at the differentiable iterate: f_new equals f_hat
    # in value but carries the mode's derivative in theta
    det = _mc_newton_quantities(kmat, y1h, mask, stp.f_new)
    return (_mc_objective(stp.a, stp.f_new, y1h, mask)
            - det.half_logdet_b - det.half_logdet_m)


#: objective evaluations since the last reset
batched_neg_logz_mc.calls = 0


def make_mc_objective(kernel: Kernel, x, y1h, mask, tol, cache=None):
    """``(theta float64 numpy, f0 [E, s, C]) -> (float, float64 numpy grad,
    f_new [E, s, C])`` for the host optimizer: theta is cast to the
    stack's dtype and device, the value and gradient come back to the
    host in one transfer, and the latent modes and the gram ``cache``
    stay on the device."""

    def evaluate(theta, f0):
        t = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=x.dtype,
                            device=x.device)
        value, grad, f_new = batched_neg_logz_mc(kernel, tol, t, x, y1h, mask, f0, cache)
        host = torch.cat([value[None], grad]).to(torch.float64).cpu().numpy()
        return float(host[0]), host[1:], f_new

    def objective(theta, f0):
        # metered flops and bytes per evaluation (obs/cost.py, GP_XLA_COST)
        return obs_cost.observed_call("fit.host_objective", evaluate, theta, f0)

    return objective


def make_sharded_mc_objective(kernel: Kernel, x, y1h, mask, tol, mesh, cache=None):
    """:func:`make_mc_objective` over ``mesh``: this rank's block of the
    stack and its one-hot targets, the per-class modes local, the value
    and gradient all-reduced (``parallel/mesh.allreduced_objective``)."""
    from spark_gp_tpu_torch.parallel.mesh import allreduced_objective

    return allreduced_objective(make_mc_objective(kernel, x, y1h, mask, tol, cache), mesh)


# --- the device fits (``models/laplace_device.py``) --------------------------------


class MulticlassLaplaceLanes(LaplaceLanes):
    """R lanes of the softmax Laplace objective for the device optimizer:
    the host loop's Newton step over the flat ``[R * E]`` stack (one K1
    call over its ``[R * E * C, s, s]`` B_c stack) and the gradient by
    autograd through one Newton step from the modes (two K1 calls)."""

    family = "gpc_mc"
    passes = 2
    mode_loop = staticmethod(laplace_mc_mode)
    _proposal = staticmethod(_mc_proposal)
    _inner_objective = staticmethod(_mc_objective)

    def _gradient_pass(self, thetas, f, new_obj):
        r, e = f.shape[:2]
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            y, mask = self.lane_targets(r)
            log_z = _log_z_at_mode(self.lane_grams(th, grad=True), y, mask,
                                   f.reshape((r * e,) + tuple(f.shape[2:])))
            values = -log_z.reshape(r, e).sum(-1)
            (grad,) = torch.autograd.grad(values.sum(), th)
        return values.detach(), grad


def fit_gpc_mc_device(kernel: Kernel, tol, log_space: bool, theta0, lower, upper, x, y1h, mask,
                      max_iter: int, cache=None, loop_metrics=None):
    """The single-start device fit of the multiclass classifier (JAX
    ``fit_gpc_mc_device``) from zero latents ``[E, s, C]``.  Returns device
    tensors ``(theta, f_latents [E, s, C], nll, n_iter, n_fev, stalled)``."""
    lanes = MulticlassLaplaceLanes(kernel, x, y1h, mask, tol, cache)
    return fit_latent_device(lanes, log_space, theta0, lower, upper, max_iter, tol,
                             loop_metrics=loop_metrics)


def fit_gpc_mc_device_multistart(kernel: Kernel, tol, log_space: bool, theta0_batch, lower,
                                 upper, x, y1h, mask, max_iter: int, cache=None,
                                 loop_metrics=None):
    """R restarts as one device loop (JAX ``fit_gpc_mc_device_multistart``),
    every Newton iteration one K1 launch over all lanes' B_c stacks:
    ``(theta_best, f_latents_best, nll_best, n_iter, n_fev, stalled,
    f_all [R], best)``."""
    lanes = MulticlassLaplaceLanes(kernel, x, y1h, mask, tol, cache)
    return fit_latent_device_multistart(lanes, log_space, theta0_batch, lower, upper, max_iter,
                                        tol, loop_metrics=loop_metrics)


def fit_gpc_mc_device_checkpointed(kernel: Kernel, tol, log_space: bool, theta0, lower, upper,
                                   x, y1h, mask, max_iter: int, chunk: int, saver, cache=None,
                                   loop_metrics=None):
    """The segmented multiclass device fit (JAX
    ``fit_gpc_mc_device_checkpointed``, ``segment_meta`` kind ``"gpc_mc"``
    with ``num_classes``)."""
    lanes = MulticlassLaplaceLanes(kernel, x, y1h, mask, tol, cache)
    return fit_latent_device_checkpointed(lanes, "gpc_mc", log_space, theta0, lower, upper,
                                          max_iter, tol, chunk, saver, loop_metrics=loop_metrics,
                                          num_classes=int(y1h.shape[-1]))

