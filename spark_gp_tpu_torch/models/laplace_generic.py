"""The Laplace approximation for any pointwise log-concave likelihood, the
port of the JAX package's ``models/laplace_generic.py``.

A likelihood is one function ``log_lik(f, y)``, per point; its gradient
and negative Hessian come from ``grad_hess`` (autograd by default, closed
forms for the four likelihoods here).  Over the ``[E, s]`` expert stack:

* the mode loop is the binary classifier's (``models/laplace.py``):
  Newton steps ``a = b - sqrt(W) B^-1 sqrt(W) K b`` with
  ``b = W f + grad log p``, ``f' = K a`` and ``B = I + sqrt(W) K sqrt(W)``,
  per-expert step halving, one host read a Newton iteration;
* the gradient in theta is autograd's through one Newton step from the
  mode (found without gradients), with ``log|B|`` evaluated at the
  stepped iterate: the Newton map's derivative in ``f`` vanishes at the
  mode, so the step carries the mode's implicit derivative.

``B`` needs ``W > 0``: Bernoulli, Binomial, Poisson and Negative Binomial
with their standard links all qualify.  On the exact lane ``B^-1`` and
``log|B|`` come from ``spd_linalg.batched_spd_inv_logdet``: on a CUDA
float32 stack with ``s <= 512`` the hand-written kernel K1, else one
batched Cholesky; the Newton step's solve takes one refinement step
through that inverse.  On the iterative lanes (matfree included: the B
systems are materialized) they are preconditioned CG and SLQ
(``ops/iterative.py``).

Counters: ``laplace_generic_mode.iterations`` (Newton iterations) and
``batched_neg_logz_generic.calls`` (objective evaluations).  On the exact
lane K1 runs once a Newton iteration and twice an evaluation.  The device
fits (:func:`fit_generic_device` and its variants,
``models/laplace_device.py``) run the same Newton step and gradient inside
the device optimizer's captured step.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

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


def _softplus(x):
    """``log(1 + e^x)``, exact on both tails (torch's ``softplus`` turns
    linear above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Likelihood:
    """A pointwise likelihood: ``log_lik(f, y) -> log p(y | f)``; equal and
    hashed by type and ``_spec()``.  ``grad_hess`` returns ``(d log p / df,
    -d^2 log p / df^2)`` elementwise, by autograd unless a subclass gives
    a closed form."""

    def _spec(self) -> tuple:
        return ()

    def __hash__(self) -> int:
        return hash((type(self), self._spec()))

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._spec() == other._spec()

    def log_lik(self, f, y):
        raise NotImplementedError

    def grad_hess(self, f, y):
        g = torch.func.grad(self.log_lik, argnums=0)
        h = torch.func.grad(g, argnums=0)
        flat_f, flat_y = f.reshape(-1), y.reshape(-1)
        grad = torch.func.vmap(g)(flat_f, flat_y).reshape(f.shape)
        hess = torch.func.vmap(h)(flat_f, flat_y).reshape(f.shape)
        return grad, -hess


class PoissonLikelihood(Likelihood):
    """Counts with the log link, ``y | f ~ Poisson(exp(f))``:
    ``log p = y f - exp(f)`` (``log y!`` dropped), ``W = exp(f)``."""

    def log_lik(self, f, y):
        return y * f - torch.exp(f)

    def grad_hess(self, f, y):
        ef = torch.exp(f)
        return y - ef, ef


class BernoulliLikelihood(Likelihood):
    """{0, 1} labels with the sigmoid link, the binary classifier's
    likelihood through the generic core."""

    def log_lik(self, f, y):
        return torch.nn.functional.logsigmoid((2.0 * y - 1.0) * f)

    def grad_hess(self, f, y):
        pi = torch.sigmoid(f)
        return y - pi, pi * (1.0 - pi)


class BinomialLikelihood(Likelihood):
    """``y`` successes of ``trials``, logit link:
    ``log p = y f - trials log(1 + e^f)``, ``W = trials pi (1 - pi)``."""

    def __init__(self, trials: int) -> None:
        trials = int(trials)
        if trials < 1:
            raise ValueError("trials must be a positive integer")
        self.trials = trials

    def _spec(self) -> tuple:
        return (self.trials,)

    def log_lik(self, f, y):
        return y * f + self.trials * torch.nn.functional.logsigmoid(-f)

    def grad_hess(self, f, y):
        pi = torch.sigmoid(f)
        return y - self.trials * pi, self.trials * pi * (1.0 - pi)


class NegativeBinomialLikelihood(Likelihood):
    """Overdispersed counts, log link: ``y | f ~ NB(mean exp(f), dispersion
    r)``, ``Var = mean + mean^2 / r``.  ``log p = y f - (y + r)
    softplus(f - log r)``, ``W = (y + r) s (1 - s)`` with ``s =
    sigmoid(f - log r)``; Poisson in the limit ``r -> inf``."""

    def __init__(self, dispersion: float) -> None:
        dispersion = float(dispersion)
        if not dispersion > 0:
            raise ValueError("dispersion must be positive")
        self.dispersion = dispersion

    def _spec(self) -> tuple:
        return (self.dispersion,)

    def log_lik(self, f, y):
        r = self.dispersion
        return y * f - (y + r) * _softplus(f - math.log(r))

    def grad_hess(self, f, y):
        r = self.dispersion
        s = torch.sigmoid(f - math.log(r))
        return y - (y + r) * s, (y + r) * s * (1.0 - s)


class GenStep(NamedTuple):
    a: torch.Tensor                         # [E, s]
    f_new: torch.Tensor                     # [E, s]
    half_logdet_b: Optional[torch.Tensor]   # [E]


def _gen_newton_quantities(lik: Likelihood, kmat, y, mask, f,
                           with_logdet: bool = True) -> GenStep:
    """One Newton step from ``f`` over the stack, with ``1/2 log|B|`` at
    ``f``; differentiable in ``kmat`` and ``f``.  Padded rows are inert
    (``sqrt(W)`` is masked, so ``B`` has unit padded rows).
    ``with_logdet=False`` skips the iterative lanes' SLQ log-det, which a
    Newton step does not read (``half_logdet_b`` is then None there)."""
    grad_log_p, w = lik.grad_hess(f, y)
    w = w * mask
    grad_log_p = grad_log_p * mask
    # double-where sqrt guard: W underflows to 0 where the likelihood
    # saturates, where sqrt's derivative is infinite
    w_pos = w > 0.0
    sqw = torch.where(w_pos, torch.sqrt(torch.where(w_pos, w, 1.0)), 0.0)
    eye = torch.eye(kmat.shape[-1], dtype=kmat.dtype, device=kmat.device)
    b_mats = eye + sqw[:, :, None] * kmat * sqw[:, None, :]
    b_vec = w * f + grad_log_p
    kb = torch.einsum("eij,ej->ei", kmat, b_vec)
    if it_ops.resolve_solver(kmat.shape[-1], num_experts=kmat.shape[0],
                             itemsize=kmat.element_size()) in ("iterative", "matfree"):
        precond = it_ops.build_spd_preconditioner(b_mats)
        half_logdet_b = (0.5 * it_ops.spd_logdet(b_mats, precond=precond)
                         if with_logdet else None)
        a = b_vec - sqw * it_ops.spd_solve(b_mats, sqw * kb, precond=precond)
    else:
        binv, logdet_b = spd_linalg.batched_spd_inv_logdet(b_mats)
        half_logdet_b = 0.5 * logdet_b
        rhs = sqw * kb
        sol = torch.einsum("eij,ej->ei", binv, rhs)
        # one step of iterative refinement against B itself: at a large W
        # (Poisson counts of ~20 on a smooth gram, cond(B) ~ 1e4) the
        # float32 explicit inverse alone sends the mode loop astray, where
        # the refined solve keeps a triangular solve's accuracy
        resid = rhs - torch.einsum("eij,ej->ei", b_mats, sol)
        sol = sol + torch.einsum("eij,ej->ei", binv, resid)
        a = b_vec - sqw * sol
    f_new = torch.einsum("eij,ej->ei", kmat, a)
    return GenStep(a, f_new, half_logdet_b)


def _gen_objective(lik: Likelihood, a, f_new, y, mask):
    """``-a^T f / 2 + sum_i mask_i log p(y_i | f_i)`` per expert."""
    ll = torch.func.vmap(lik.log_lik)(f_new.reshape(-1), y.reshape(-1)).reshape(f_new.shape)
    return -0.5 * torch.sum(a * f_new, dim=-1) + torch.sum(ll * mask, dim=-1)


def _gen_proposal(lik: Likelihood):
    """``(kmat, y, mask, f) -> (a, K a)``: one Newton step from latent ``f``
    for ``lik`` (no log-det)."""
    def proposal(kmat, y, mask, f):
        stp = _gen_newton_quantities(lik, kmat, y, mask, f, with_logdet=False)
        return stp.a, stp.f_new

    return proposal


@torch.no_grad()
def laplace_generic_mode(lik: Likelihood, kmat, y, mask, f0, tol):
    """Newton's method with per-expert step halving over the whole stack,
    the binary loop's acceptance and termination for any likelihood
    (``laplace_device.newton_update``); returns ``(f_modes [E, s],
    objective [E])``.  One host read an iteration."""
    f = f0
    old, new, step = newton_start(f0)
    proposal = _gen_proposal(lik)
    objective = functools.partial(_gen_objective, lik)
    while True:
        run = newton_running(old, new, step, tol)
        if not bool(run.any()):
            return f, new
        laplace_generic_mode.iterations += 1
        f, old, new, step = newton_update(proposal, objective, kmat, y, mask, f, old, new, step,
                                          run)


#: Newton iterations since the last reset
laplace_generic_mode.iterations = 0


def batched_neg_logz_generic(lik: Likelihood, kernel: Kernel, tol, theta, x, y, mask, f0,
                             cache=None, weights=None):
    """``(-sum_e log Z_e, its gradient in theta, f_modes [E, s])`` for any
    likelihood (module doc); ``theta`` is a tensor on the stack's device.
    With the fit's gram ``cache`` (``kernels/base.py``) the gram is built,
    and differentiated, from it.  ``weights`` (``[E]``,
    ``models/aggregation.py``) weights each expert's evidence; ``None``
    keeps the plain sum."""
    batched_neg_logz_generic.calls += 1
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        kmat = masked_gram_stack(kernel, th, x, mask, cache)
        f_hat, _ = laplace_generic_mode(lik, kmat.detach(), y, mask, f0, tol)
        value = -weighted_expert_sum(_log_z_at_mode(lik, kmat, y, mask, f_hat), weights)
        (grad,) = torch.autograd.grad(value, th)
    return value.detach(), grad, f_hat


def _log_z_at_mode(lik: Likelihood, kmat, y, mask, f_hat):
    """``log Z_e`` ``[B]`` at the mode ``f_hat``, differentiable in the
    gram ``kmat``: one Newton step from the mode, ``log|B|`` at the
    stepped iterate (module doc), two K1 calls on the exact lane."""
    stp = _gen_newton_quantities(lik, kmat, y, mask, f_hat, with_logdet=False)
    # the determinant at the differentiable iterate: f_new equals f_hat in
    # value but carries the mode's derivative in theta
    det = _gen_newton_quantities(lik, kmat, y, mask, stp.f_new)
    return _gen_objective(lik, stp.a, stp.f_new, y, mask) - det.half_logdet_b


#: objective evaluations since the last reset
batched_neg_logz_generic.calls = 0


def make_generic_objective(lik: Likelihood, kernel: Kernel, x, y, mask, tol, cache=None):
    """``(theta float64 numpy, f0 [E, s]) -> (float, float64 numpy grad,
    f_new [E, s])`` for the host optimizer: theta is cast to the stack's
    dtype and device, the value and gradient come back to the host in one
    transfer, and the latent modes (and the gram ``cache``) stay on the
    device."""

    def evaluate(theta, f0):
        t = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=x.dtype,
                            device=x.device)
        value, grad, f_new = batched_neg_logz_generic(lik, kernel, tol, t, x, y, mask, f0,
                                                      cache)
        host = torch.cat([value[None], grad]).to(torch.float64).cpu().numpy()
        return float(host[0]), host[1:], f_new

    def objective(theta, f0):
        # metered flops and bytes per evaluation (obs/cost.py, GP_XLA_COST)
        return obs_cost.observed_call("fit.host_objective", evaluate, theta, f0)

    return objective


def make_sharded_generic_objective(lik: Likelihood, kernel: Kernel, x, y, mask, tol, mesh,
                                   cache=None):
    """:func:`make_generic_objective` over ``mesh``: this rank's block, its
    modes local, the value and gradient all-reduced
    (``parallel/mesh.allreduced_objective``)."""
    from spark_gp_tpu_torch.parallel.mesh import allreduced_objective

    return allreduced_objective(make_generic_objective(lik, kernel, x, y, mask, tol, cache),
                                mesh)


# --- the device fits (``models/laplace_device.py``) --------------------------------


class GenericLaplaceLanes(LaplaceLanes):
    """R lanes of the generic-likelihood Laplace objective for the device
    optimizer: the host loop's Newton step over the flat ``[R * E]`` stack
    (one K1 call, the solve refined once through its inverse) and the
    gradient by autograd through one Newton step from the modes (two K1
    calls)."""

    family = "generic"
    passes = 2
    mode_loop = staticmethod(laplace_generic_mode)

    def __init__(self, lik: Likelihood, kernel: Kernel, x, y, mask, tol, cache=None) -> None:
        super().__init__(kernel, x, y, mask, tol, cache)
        self.lik = lik
        self.mode_args = (lik,)
        self._proposal = _gen_proposal(lik)
        self._inner_objective = functools.partial(_gen_objective, lik)

    def _gradient_pass(self, thetas, f, new_obj):
        r, e = f.shape[:2]
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            y, mask = self.lane_targets(r)
            log_z = _log_z_at_mode(self.lik, self.lane_grams(th, grad=True), y, mask,
                                   f.reshape(r * e, -1))
            values = -log_z.reshape(r, e).sum(-1)
            (grad,) = torch.autograd.grad(values.sum(), th)
        return values.detach(), grad


def segment_kind(lik: Likelihood) -> str:
    """The JAX package's ``segment_meta`` kind of a generic fit."""
    return f"generic:{type(lik).__name__}{lik._spec()}"


def fit_generic_device(lik: Likelihood, kernel: Kernel, tol, log_space: bool, theta0, lower,
                       upper, x, y, mask, max_iter: int, cache=None, loop_metrics=None):
    """The single-start device fit of a count model (JAX
    ``fit_generic_device``) from zero latents.  Returns device tensors
    ``(theta, f_latents [E, s], nll, n_iter, n_fev, stalled)``."""
    lanes = GenericLaplaceLanes(lik, kernel, x, y, mask, tol, cache)
    return fit_latent_device(lanes, log_space, theta0, lower, upper, max_iter, tol,
                             loop_metrics=loop_metrics)


def fit_generic_device_multistart(lik: Likelihood, kernel: Kernel, tol, log_space: bool,
                                  theta0_batch, lower, upper, x, y, mask, max_iter: int,
                                  cache=None, loop_metrics=None):
    """R restarts as one device loop (JAX ``fit_generic_device_multistart``):
    ``(theta_best, f_latents_best, nll_best, n_iter, n_fev, stalled,
    f_all [R], best)``."""
    lanes = GenericLaplaceLanes(lik, kernel, x, y, mask, tol, cache)
    return fit_latent_device_multistart(lanes, log_space, theta0_batch, lower, upper, max_iter,
                                        tol, loop_metrics=loop_metrics)


def fit_generic_device_checkpointed(lik: Likelihood, kernel: Kernel, tol, log_space: bool,
                                    theta0, lower, upper, x, y, mask, max_iter: int, chunk: int,
                                    saver, cache=None, loop_metrics=None):
    """The segmented count-model device fit (JAX
    ``fit_generic_device_checkpointed``, ``segment_meta`` kind
    :func:`segment_kind`)."""
    lanes = GenericLaplaceLanes(lik, kernel, x, y, mask, tol, cache)
    return fit_latent_device_checkpointed(lanes, segment_kind(lik), log_space, theta0, lower,
                                          upper, max_iter, tol, chunk, saver,
                                          loop_metrics=loop_metrics)

