"""Laplace approximation for binary GP classification (sigmoid link).

Per expert, as in the reference (GaussianProcessClassifier.scala:74-129):

* Newton's method finds the latent posterior mode ``f`` (R&W Algorithm
  3.1), accepting a step only when it raises the objective and halving it
  otherwise, while ``|old - new| > tol and step > tol``;
* the approximate log marginal likelihood ``log Z`` and its gradient in
  the hyperparameters follow R&W Algorithm 5.1, with the implicit
  correction through the mode (the ``s2``/``s3`` terms).

The loop runs over the whole ``[E, s, s]`` stack at once, with per-expert
masked updates, so each iteration factors every expert's
``B = I + sqrtW K sqrtW`` in one batched call: on a CUDA float32 stack
with ``s <= 512`` the hand-written kernel of ``ops/spd_linalg.py`` (K1),
on the CPU one batched Cholesky, on the iterative lanes preconditioned CG
and SLQ (``ops/iterative.py``).  Deciding whether to go on is one host
read a Newton iteration on the host optimizer's path; the device fits
(:func:`fit_gpc_device` and its multi-start and segmented variants,
``models/laplace_device.py``) run the same iteration without it, masked,
inside the device optimizer's captured step.

The gradient needs only the converged state, so neither the loop nor K1
is differentiated.  With ``a``, ``R = sqrtW B^-1 sqrtW``, ``g = grad log
p(y|f)`` and ``u = s2 - R K s2`` held constant, Algorithm 5.1's gradient is
that of the scalar

    L(theta) = 1/2 a^T K a - 1/2 <R, K> + u^T K g

(its ``s3 = (I - K R) dK g`` term, moved onto ``u`` by the symmetry of K
and R), so one reverse pass through the masked gram gives it, and the
``[E, s, s, h]`` stack of ``dK/dtheta`` is never built.

Padded points have ``w = 0`` and ``g = 0``: ``B`` has unit rows there and
they add nothing to any term.  The latent warm start is explicit state:
the objective returns the new ``f`` stack and the optimizer feeds it back.

Counters: ``laplace_mode_batch.iterations`` (Newton iterations) and
``batched_neg_logz.calls`` (objective evaluations); on the exact lane each
iteration and each evaluation's converged-state pass is one K1 call.
"""

from __future__ import annotations

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
from spark_gp_tpu_torch.ops.linalg import chol_logdet, chol_solve, cholesky
from spark_gp_tpu_torch.parallel.experts import ExpertData


def _posterior_terms_batch(kmat, y, mask, f, with_logdet: bool = True):
    """Quantities of Algorithms 3.1 / 5.1 at latent ``f`` for the whole
    stack: ``(pi, w, sqw, factor, logdet, grad_log_p)``, ``factor`` a
    tagged pair for :func:`_apply_binv` / :func:`_binv_full`.

    ``B``'s factorization follows the solver lane and the stack: on the
    iterative lanes (matfree too: the B systems are materialized) a
    preconditioner built once for the Newton solve, the full inverse and
    the log-det; on a stack K1 takes (``spd_linalg.kernel_applies``) K1's
    ``B^-1`` and ``log|B|`` in one call; else one batched Cholesky.
    ``with_logdet=False`` skips the iterative lane's SLQ log-det, which the
    Newton step does not read (``logdet`` is then None on that lane)."""
    pi = torch.sigmoid(f)
    w = pi * (1.0 - pi) * mask
    sqw = torch.sqrt(w)
    eye = torch.eye(kmat.shape[-1], dtype=kmat.dtype, device=kmat.device)
    b_mat = eye + sqw[:, :, None] * kmat * sqw[:, None, :]
    grad_log_p = (y - pi) * mask
    if it_ops.resolve_solver(kmat.shape[-1], num_experts=kmat.shape[0],
                             itemsize=kmat.element_size()) in ("iterative", "matfree"):
        precond = it_ops.build_spd_preconditioner(b_mat)
        logdet = it_ops.spd_logdet(b_mat, precond=precond) if with_logdet else None
        return pi, w, sqw, ("iter", (b_mat, precond)), logdet, grad_log_p
    if spd_linalg.kernel_applies(b_mat):
        binv, logdet = spd_linalg.spd_inv_logdet(b_mat)
        return pi, w, sqw, ("inv", binv), logdet, grad_log_p
    chol_l = cholesky(b_mat)
    return pi, w, sqw, ("chol", chol_l), chol_logdet(chol_l), grad_log_p


def _apply_binv(factor, v):
    """``B^-1 v`` per expert (``v`` is ``[E, s]``)."""
    tag, mat = factor
    if tag == "inv":
        return torch.einsum("eij,ej->ei", mat, v)
    if tag == "iter":
        b_mat, precond = mat
        return it_ops.spd_solve(b_mat, v, precond=precond)
    return chol_solve(mat, v)


def _binv_full(factor):
    """Explicit ``B^-1 [E, s, s]``, which Algorithm 5.1 consumes: K1's
    output, else ``s`` right-hand sides through the factor (one multi-RHS
    CG solve on the iterative lanes, once an evaluation)."""
    tag, mat = factor
    if tag == "inv":
        return mat
    b_mat = mat[0] if tag == "iter" else mat
    eye = torch.eye(b_mat.shape[-1], dtype=b_mat.dtype, device=b_mat.device)
    eye = eye.expand(b_mat.shape)
    if tag == "iter":
        return it_ops.spd_solve(b_mat, eye, precond=mat[1])
    return chol_solve(mat, eye)


def _newton_a_batch(kmat, w, sqw, factor, grad_log_p, f):
    """``a = b - sqrtW B^-1 sqrtW K b`` with ``b = W f + grad_log_p``
    (GPClf.scala:100-101), for every expert."""
    b = w * f + grad_log_p
    kb = torch.einsum("eij,ej->ei", kmat, b)
    return b - sqw * _apply_binv(factor, sqw * kb)


def _objective_batch(a, f_new, y, mask):
    """``-a^T f / 2 + sum log sigmoid((2y - 1) f)`` over the real points
    (GPClf.scala:102), per expert."""
    return -0.5 * torch.sum(a * f_new, dim=-1) + torch.sum(
        mask * torch.nn.functional.logsigmoid((2.0 * y - 1.0) * f_new), dim=-1
    )


def _newton_proposal(kmat, y, mask, f):
    """``(a, K a)``: one Newton step's ``a`` from latent ``f`` and the full
    step's latent, for the whole stack (the iterative lanes skip the
    log-det, which the step does not read)."""
    _, w, sqw, factor, _, grad_log_p = _posterior_terms_batch(kmat, y, mask, f,
                                                             with_logdet=False)
    a = _newton_a_batch(kmat, w, sqw, factor, grad_log_p, f)
    return a, torch.einsum("eij,ej->ei", kmat, a)


@torch.no_grad()
def laplace_mode_batch(kmat, y, mask, f0, tol):
    """Newton's method with per-expert step halving over the whole stack;
    returns ``(f_modes [E, s], objective [E])``.

    Acceptance and termination are the reference's per expert
    (GPClf.scala:91-111): a candidate is accepted iff its objective beats
    ``old``, else that expert's step halves; an expert whose
    ``|old - new| > tol and step > tol`` has failed freezes while the
    others go on (``laplace_device.newton_update``).  The loop ends when
    no expert runs, which is one host read an iteration."""
    f = f0
    old, new, step = newton_start(f0)
    while True:
        run = newton_running(old, new, step, tol)
        if not bool(run.any()):
            return f, new
        laplace_mode_batch.iterations += 1
        f, old, new, step = newton_update(_newton_proposal, _objective_batch, kmat, y, mask, f,
                                          old, new, step, run)


#: Newton iterations since the last reset
laplace_mode_batch.iterations = 0


def batched_neg_logz(kernel: Kernel, tol, theta, data: ExpertData, f0, cache=None,
                     weights=None):
    """``(-sum_e log Z_e, its gradient in theta, f_modes [E, s])`` over the
    expert stack (module doc); ``theta`` is a tensor on the stack's
    device.  With the fit's gram ``cache`` (``kernels/base.py``) the
    surrogate's reverse pass differentiates only the theta map, not the
    distances.  ``weights`` (``[E]``, ``models/aggregation.py``) makes the
    evidence and its gradient ``sum_e w_e (.)_e``; ``None`` keeps the
    plain sums."""
    batched_neg_logz.calls += 1
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        kmat_g = masked_gram_stack(kernel, th, data.x, data.mask, cache)
    with torch.no_grad():
        f, new_obj = laplace_mode_batch(kmat_g.detach(), data.y, data.mask, f0, tol)
    log_z, grad = _converged_pass(kmat_g, th, data.y, data.mask, f, new_obj, weights)
    return -weighted_expert_sum(log_z, weights), -grad, f


def _converged_pass(kmat_g, th, y, mask, f, new_obj, weights=None):
    """``(log Z_e [B], d/dtheta of the surrogate)`` at the converged modes
    ``f`` of a ``[B, s, s]`` gram stack ``kmat_g`` that carries theta's
    graph (module doc): the reference's last iteration (f is fixed), one
    K1 call on the exact lane, then one reverse pass.  The surrogate sums
    over the stack, so ``th`` may hold several lanes' thetas whose grams
    the stack concatenates: each lane's gradient is its own."""
    kmat = kmat_g.detach()
    with torch.no_grad():
        pi, w, sqw, factor, logdet, grad_log_p = _posterior_terms_batch(kmat, y, mask, f)
        a = _newton_a_batch(kmat, w, sqw, factor, grad_log_p, f)
        binv = _binv_full(factor)
        log_z = new_obj - 0.5 * logdet
        # Algorithm 5.1 (GPClf.scala:115-126): R = sqrtW B^-1 sqrtW, and
        # diag(K sqrtW B^-1 sqrtW K) as the row sums of (K sqrtW B^-1) * K sqrtW
        r_mat = sqw[:, :, None] * binv * sqw[:, None, :]
        ksq = kmat * sqw[:, None, :]
        csum = torch.sum((ksq @ binv) * ksq, dim=-1)
        # d^3/df^3 log p(y|f) = -(2 pi - 1) pi (1 - pi)
        d3_log_p = -(2.0 * pi - 1.0) * pi * (1.0 - pi) * mask
        kdiag = torch.diagonal(kmat, dim1=-2, dim2=-1)
        s2 = -0.5 * (kdiag - csum) * d3_log_p
        u = s2 - torch.einsum("eij,ej->ei", r_mat, torch.einsum("eij,ej->ei", kmat, s2))
        # each expert's surrogate terms at its weight
        wa, wr, wu = a, r_mat, u
        if weights is not None:
            w = torch.as_tensor(weights, dtype=kmat.dtype, device=kmat.device)
            wa, wr, wu = a * w[:, None], r_mat * w[:, None, None], u * w[:, None]
    with torch.enable_grad():
        surrogate = (
            0.5 * torch.einsum("ei,eij,ej->", wa, kmat_g, a)
            - 0.5 * torch.sum(wr * kmat_g)
            + torch.einsum("ei,eij,ej->", wu, kmat_g, grad_log_p)
        )
        (grad,) = torch.autograd.grad(surrogate, th)
    return log_z, grad


#: objective evaluations since the last reset
batched_neg_logz.calls = 0


# --- single-expert wrappers (tests / parity oracles) ----------------------


def laplace_mode(kmat, y, mask, f0, tol):
    """One expert's Newton loop, through the batch core."""
    f, obj = laplace_mode_batch(kmat[None], y[None], mask[None], f0[None], tol)
    return f[0], obj[0]


def expert_neg_logz_and_grad(kernel: Kernel, tol, theta, x, y, mask, f0):
    """One expert's ``(-log Z, -dlogZ/dtheta, f_mode)``, through the batch
    core."""
    data = ExpertData(x=x[None], y=y[None], mask=mask[None])
    neg_z, neg_grad, f = batched_neg_logz(kernel, tol, theta, data, f0[None])
    return neg_z, neg_grad, f[0]


def make_laplace_objective(kernel: Kernel, data: ExpertData, tol, cache=None):
    """``(theta float64 numpy, f0 [E, s]) -> (float, float64 numpy grad,
    f_new [E, s])`` for the host optimizer: theta is cast to the stack's
    dtype and device, the value and gradient come back to the host in one
    transfer, and the latent modes (and the gram ``cache``) stay on the
    device."""

    def evaluate(theta, f0):
        t = torch.as_tensor(
            np.asarray(theta, dtype=np.float64), dtype=data.x.dtype, device=data.x.device
        )
        value, grad, f_new = batched_neg_logz(kernel, tol, t, data, f0, cache)
        host = torch.cat([value[None], grad]).to(torch.float64).cpu().numpy()
        return float(host[0]), host[1:], f_new

    def objective(theta, f0):
        # metered flops and bytes per evaluation (obs/cost.py, GP_XLA_COST)
        return obs_cost.observed_call("fit.host_objective", evaluate, theta, f0)

    return objective


def make_sharded_laplace_objective(kernel: Kernel, data: ExpertData, tol, mesh, cache=None):
    """:func:`make_laplace_objective` over ``mesh``: ``data`` (and
    ``cache``) is this rank's block, the latent modes stay on their rank,
    and the value and gradient, each rank's sum over its experts, are
    all-reduced (``parallel/mesh.allreduced_objective``).  The gradient is
    assembled by hand (Alg. 5.1), so it needs that sum as much as the
    value."""
    from spark_gp_tpu_torch.parallel.mesh import allreduced_objective

    return allreduced_objective(make_laplace_objective(kernel, data, tol, cache), mesh)


# --- the device fits (``models/laplace_device.py``) --------------------------------


class BinaryLaplaceLanes(LaplaceLanes):
    """R lanes of the binary Laplace objective for the device optimizer:
    the host loop's Newton step and Algorithm 5.1's converged pass over the
    flat ``[R * E, s, s]`` stack, one K1 call each."""

    family = "gpc"
    passes = 1
    mode_loop = staticmethod(laplace_mode_batch)
    _proposal = staticmethod(_newton_proposal)
    _inner_objective = staticmethod(_objective_batch)

    def __init__(self, kernel: Kernel, data: ExpertData, tol, cache=None):
        super().__init__(kernel, data.x, data.y, data.mask, tol, cache)

    def _gradient_pass(self, thetas, f, new_obj):
        r, e, s = f.shape
        th = thetas.detach().requires_grad_(True)
        kmat_g = self.lane_grams(th, grad=True)
        y, mask = self.lane_targets(r)
        log_z, grad = _converged_pass(kmat_g, th, y, mask, f.reshape(r * e, s),
                                      new_obj.reshape(-1))
        return -log_z.reshape(r, e).sum(-1), -grad


def fit_gpc_device(kernel: Kernel, tol, log_space: bool, theta0, lower, upper, data: ExpertData,
                   max_iter: int, cache=None, capture: bool = True, loop_metrics=None):
    """The single-start device fit of the binary classifier (JAX
    ``fit_gpc_device``): the latent warm-start stack is the optimizer's
    aux carry.  ``theta0``, ``lower``, ``upper`` are tensors in the stack's
    dtype and device.  Returns device tensors ``(theta, f_latents [E, s],
    nll, n_iter, n_fev, stalled)``."""
    lanes = BinaryLaplaceLanes(kernel, data, tol, cache)
    return fit_latent_device(lanes, log_space, theta0, lower, upper, max_iter, tol,
                             capture=capture, loop_metrics=loop_metrics)


def fit_gpc_device_multistart(kernel: Kernel, tol, log_space: bool, theta0_batch, lower, upper,
                              data: ExpertData, max_iter: int, cache=None, loop_metrics=None):
    """R restarts as one device loop (JAX ``fit_gpc_device_multistart``):
    ``(theta_best, f_latents_best, nll_best, n_iter, n_fev, stalled,
    f_all [R], best)``."""
    lanes = BinaryLaplaceLanes(kernel, data, tol, cache)
    return fit_latent_device_multistart(lanes, log_space, theta0_batch, lower, upper, max_iter,
                                        tol, loop_metrics=loop_metrics)


def fit_gpc_device_checkpointed(kernel: Kernel, tol, log_space: bool, theta0, lower, upper,
                                data: ExpertData, max_iter: int, chunk: int, saver, cache=None,
                                loop_metrics=None):
    """The segmented binary device fit (JAX ``fit_gpc_device_checkpointed``,
    ``segment_meta`` kind ``"gpc"``): a resume continues from the saved
    modes.  Returns the single-start fit's tuple."""
    lanes = BinaryLaplaceLanes(kernel, data, tol, cache)
    return fit_latent_device_checkpointed(lanes, "gpc", log_space, theta0, lower, upper,
                                          max_iter, tol, chunk, saver, loop_metrics=loop_metrics)

