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

Every evaluation runs on the precision lane in effect
(``ops/precision.py``: ``precision_lane_scope`` is the one way to pin
it); the device objective resolves it once a fit and pins it around its
captured step.  :func:`guard_probe_value_and_grad` evaluates one probe
stack at an explicit lane for the fit-time precision guard.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack, supports_matfree
from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops.linalg import chol_logdet, chol_solve, cholesky, trace_scale
from spark_gp_tpu_torch.ops.precision import precision_lane_scope
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
                weights=None, reduce: bool = True):
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
    ``sum_e w_e NLL_e``.  ``None`` for either keeps the plain sum.
    ``reduce=False`` returns the ``[E]`` per-expert NLLs unsummed (and
    unweighted) from the same single pass: the fit-time expert-quality
    probe (``resilience/quarantine.expert_nll``)."""
    resolved = it_ops.resolve_for(data)
    if not reduce:
        weights = None
    ym = data.y * data.mask
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=data.x.dtype, device=data.x.device)
    if resolved == "matfree" and supports_matfree(kernel):
        # this branch runs before any gram is built: every product streams,
        # and the ridge rides the operator
        quad, logdet = it_ops.inv_quad_logdet_matfree(
            *masked_matfree_operator(kernel, theta, data.x, data.mask, jitter), ym
        )
        if not reduce:
            return 0.5 * quad + 0.5 * logdet
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
        if not reduce:
            return 0.5 * quad + 0.5 * logdet
        return _quad_logdet_nll(quad, logdet, weights)
    if not reduce:
        if kernel_applies(kmat):
            kinv, logdet = spd_inv_logdet(kmat)
            alpha = torch.einsum("eij,ej->ei", kinv, ym)
        else:
            chol_l = cholesky(kmat)
            alpha, logdet = chol_solve(chol_l, ym), chol_logdet(chol_l)
        return 0.5 * torch.einsum("ei,ei->e", ym, alpha) + 0.5 * logdet
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


def objective_supports_shard_map(objective: str) -> bool:
    """The JAX package's dispatch rule, which path it takes over a mesh: an
    objective that is a sum over experts (the marginal NLL, LOO) sums its
    ranks' partial sums in ``shard_map``; the ELBO, a nonlinear function of
    global sums, rides GSPMD there.  The port sums every objective over
    the ranks (the ELBO its sums, ``models/sgpr.elbo_value_and_grad``), so
    it only reports."""
    return objective != "elbo"


def make_value_and_grad(kernel: Kernel, data: ExpertData, cache=None,
                        objective: str = "marginal", extra=(), mesh=None):
    """``theta (float64 numpy) -> (float, float64 numpy grad)`` of
    ``objective`` (:func:`objective_fn`; ``extra`` is the ELBO's
    ``(active [m, p] numpy, sigma2)``): theta is cast to the stack's dtype
    and device, and the value and gradient come back to the host in one
    transfer.  ``cache``: as for :func:`batched_nll`, resident on the
    device across evaluations.  Each evaluation runs on the precision lane
    in effect at its call.  The ELBO runs its two passes
    (``models/sgpr.elbo_value_and_grad``), its sums all-reduced over
    ``mesh`` when one is given (``data`` this rank's block); ``mesh`` is
    only for the ELBO (:func:`make_sharded_value_and_grad` sums the
    others)."""
    fn = objective_fn(objective)
    extra = _objective_operands(data, objective, extra)
    if objective == "elbo":
        from spark_gp_tpu_torch.models.sgpr import elbo_value_and_grad

        reduce = None if mesh is None else mesh.all_reduce

    def evaluate(theta):
        t = torch.as_tensor(
            np.asarray(theta, dtype=np.float64), dtype=data.x.dtype,
            device=data.x.device,
        )
        if objective == "elbo":
            value, grad = elbo_value_and_grad(kernel, t[None], data, *extra, reduce=reduce)
            value, grad = value[0], grad[0]
        else:
            t.requires_grad_(True)
            value = fn(kernel, t, data, cache, *extra)
            (grad,) = torch.autograd.grad(value, t)
        host = torch.cat([value.detach()[None], grad]).to(torch.float64).cpu().numpy()
        return float(host[0]), host[1:]

    def vag(theta):
        # metered flops and bytes per evaluation (obs/cost.py, GP_XLA_COST)
        return obs_cost.observed_call("fit.host_objective", evaluate, theta)

    return vag


def make_sharded_value_and_grad(kernel: Kernel, data: ExpertData, mesh,
                                objective: str = "marginal", cache=None, weights=None,
                                extra=()):
    """``theta -> (nll, grad)`` summed over the ranks of ``mesh``: ``data``
    is this rank's block of the stack (``parallel/mesh.shard_experts``,
    ``distribute_global_experts``), ``cache`` and ``weights`` its blocks of
    the gram cache and the ``[E]`` aggregation weights.  The marginal and
    LOO objectives: each rank takes its experts' value and autograd
    gradient (:func:`make_value_and_grad`: one K1 launch on the exact lane,
    K2 / K2-VJP and the quadrature on the matfree lane), then one
    all-reduce sums both in float64; theta is replicated.  The ELBO
    (``extra`` its ``(active, sigma2)``): the bound of the all-reduced sums
    and the all-reduced vector-Jacobian product of each rank's sums
    (``models/sgpr.elbo_value_and_grad``), two collectives.  The jitter
    operand of the recovery loop rides no sharded path (the JAX package's
    rule)."""
    if objective == "elbo":
        return make_value_and_grad(kernel, data, None, objective, extra, mesh=mesh)
    extra = () if weights is None or objective != "marginal" else (None, weights)
    local = make_value_and_grad(kernel, data, cache, objective, extra)
    from spark_gp_tpu_torch.parallel.mesh import allreduced_objective

    return allreduced_objective(local, mesh)


def guard_probe_value_and_grad(kernel: Kernel, theta, x, y, mask, *, lane: str):
    """``(NLL, grad)`` of one probe stack at an explicit precision ``lane``:
    the objective leg of the fit-time precision guard
    (``models/common._emit_precision_guard``).  Like the fit, the probe
    builds the kernel's gram cache when it has one -- under the probed
    lane, so the lane's cache build is part of what the guard compares --
    and the masked gram from it, in the stack's dtype.  The NLL and its
    gradient through that gram are then taken in float64 by one Cholesky,
    whatever solver lane the fit ran: the port's linear-algebra stage
    reads no lane (K1, the SPD VJP and the CG engine run the same float32
    arithmetic on every lane), so the gram is the one thing a lane
    changes, and the guard measures it rather than float32 rounding that
    every lane shares -- on an airfoil expert at sigma2 1e-4 the strict
    lane's own float32 inverse route leaves its gradient 1e-2 .. 4e-2 from
    float64 (PERF.md §6) -- or the CG lanes' stochastic log-det.
    ``theta`` is a tensor in the stack's dtype and device; the value and
    gradient come back in float64."""
    from spark_gp_tpu_torch.kernels.base import prepare_gram_cache

    with precision_lane_scope(lane), torch.enable_grad():
        cache = prepare_gram_cache(kernel, x)
        t = theta.detach().clone().requires_grad_(True)
        kmat = masked_gram_stack(kernel, t, x, mask, cache).to(torch.float64)
        value = nll_from_cholesky(kmat, (y * mask).to(torch.float64))
        (grad,) = torch.autograd.grad(value, t)
    return value.detach(), grad.to(torch.float64)


# --- the on-device optimizer's objectives and fits -----------------------------
#
# The device fits (``optimize/lbfgs_device.py``) evaluate R lanes of
# theta at once and keep value and gradient on the device, on every solver
# lane.  The lane resolves once a fit (:func:`_device_fit_scope`), as the
# JAX package's ``solver=`` jit key.  The CG / SLQ lanes run a fixed trip
# count with converged columns frozen by a mask (``ops/iterative.py``), so
# a captured step holds them; their probes are drawn once a fit, at the
# first evaluation (``ops.iterative.ProbeSet``), and their quadrature is a
# kernel the capture can hold (``ops/slq_quadrature.py``).


def _lane_grams(kernel: Kernel, thetas, data: ExpertData, cache=None, jitter=None):
    """``[R, E, s, s]``: the masked (and optionally jittered) gram stack of
    each lane's theta."""
    kmat = torch.stack([masked_gram_stack(kernel, thetas[r], data.x, data.mask, cache)
                        for r in range(thetas.shape[0])])
    if jitter is not None:
        s = kmat.shape[-1]
        scale = trace_scale(torch.diagonal(kmat, dim1=-2, dim2=-1).sum(-1), s)
        boost = jitter if isinstance(jitter, torch.Tensor) else float(jitter)
        kmat = kmat + (boost * scale)[..., None, None] * torch.eye(
            s, dtype=kmat.dtype, device=kmat.device)
    return kmat


def lanes_nll(kernel: Kernel, thetas, data: ExpertData, cache=None, jitter=None, weights=None):
    """``[R]``: the BCM NLL (:func:`batched_nll`) of each lane's theta.  On
    the exact lane the R lanes' gram stacks go through one batched inverse:
    one K1 launch over ``[R * E, s, s]`` where the kernel applies, one
    batched Cholesky otherwise; on the CG lanes each lane runs the solver
    engine on its own stack (or streamed operator), lane after lane, on the
    same probes, as the JAX package's vmapped lanes do."""
    r = thetas.shape[0]
    if it_ops.resolve_for(data) in ("iterative", "matfree"):
        return torch.stack([batched_nll(kernel, thetas[i], data, cache, jitter, weights)
                            for i in range(r)])
    kmat = _lane_grams(kernel, thetas, data, cache, jitter)
    e, s = kmat.shape[1], kmat.shape[-1]
    flat = kmat.reshape(r * e, s, s)
    ym = (data.y * data.mask).repeat(r, 1)
    if kernel_applies(flat):
        kinv, logdet = spd_inv_logdet(flat)
        alpha = torch.einsum("bij,bj->bi", kinv, ym)
    else:
        chol_l = cholesky(flat)
        alpha, logdet = chol_solve(chol_l, ym), chol_logdet(chol_l)
    quad = torch.einsum("bi,bi->b", ym, alpha).reshape(r, e)
    logdet = logdet.reshape(r, e)
    if weights is None:
        return 0.5 * quad.sum(-1) + 0.5 * logdet.sum(-1)
    w = weights if isinstance(weights, torch.Tensor) else torch.as_tensor(
        weights, dtype=quad.dtype, device=quad.device)
    return 0.5 * (quad * w).sum(-1) + 0.5 * (w * logdet).sum(-1)


def lanes_objective(objective: str):
    """The lanes counterpart of :func:`objective_fn` for the marginal and
    LOO objectives: ``(kernel, thetas [R, h], data, cache, *extra) ->
    values [R]``."""
    if objective == "marginal":
        return lanes_nll
    if objective == "loo":
        from spark_gp_tpu_torch.models.loo import lanes_loo_nll

        return lambda kernel, thetas, data, cache, *extra: lanes_loo_nll(
            kernel, thetas, data, cache)
    raise ValueError(
        f"unknown objective {objective!r}; expected 'marginal' or 'loo' (the ELBO's "
        "lanes are models/sgpr.elbo_value_and_grad)"
    )


def _objective_operands(data: ExpertData, objective: str, extra=()):
    """``extra`` with the ELBO's inducing set as a tensor in the stack's
    dtype and device and sigma2 a float (the other objectives' operands
    already are what they need)."""
    if objective != "elbo":
        return tuple(extra)
    active, sigma2 = extra
    return (torch.as_tensor(np.asarray(active, dtype=np.float64), dtype=data.x.dtype,
                            device=data.x.device), float(sigma2))


def make_device_value_and_grad(kernel: Kernel, data: ExpertData, cache=None,
                               objective: str = "marginal", extra=(), mesh=None):
    """``thetas [R, h] -> (values [R], grads [R, h])`` of ``objective`` on the
    stack's device, nothing read back to the host: the function the device
    optimizer's captured step evaluates.  ``extra`` as for
    :func:`make_value_and_grad`.  The precision lane in effect is resolved
    here, once a fit, and pinned around every evaluation, so the captured
    step holds that lane's gram.  With ``mesh``, ``data`` is this rank's
    block and the values and gradients are summed over the ranks by one
    all-reduce on the device (``parallel/mesh.allreduced_lanes``); the
    ELBO's two passes all-reduce its sums and then its gradient
    (``models/sgpr.elbo_value_and_grad``), on the device too."""
    from spark_gp_tpu_torch.ops.precision import active_lane

    extra = _objective_operands(data, objective, extra)
    lane = active_lane()
    if objective == "elbo":
        from spark_gp_tpu_torch.models.sgpr import elbo_value_and_grad

        reduce = None if mesh is None else mesh.all_reduce

        def elbo_vag(thetas):
            with precision_lane_scope(lane):
                return elbo_value_and_grad(kernel, thetas, data, *extra, reduce=reduce)

        return elbo_vag
    fn = lanes_objective(objective)
    # the CG lanes' probes, drawn at the fit's first evaluation and kept
    probes = it_ops.ProbeSet(experts=data.num_experts)

    def vag(thetas):
        with torch.enable_grad(), it_ops.probe_scope(probes), precision_lane_scope(lane):
            t = thetas.detach().requires_grad_(True)
            values = fn(kernel, t, data, cache, *extra)
            (grad,) = torch.autograd.grad(values.sum(), t)
        return values.detach(), grad

    if mesh is not None:
        from spark_gp_tpu_torch.parallel.mesh import allreduced_lanes

        return allreduced_lanes(vag, mesh)
    return vag


@contextlib.contextmanager
def _device_fit_scope(data: ExpertData, mesh=None):
    """The ``fit.device`` span (``fit.device.sharded`` over a mesh) around a
    device fit (the JAX package's cost entries of the same names), with
    the fit's solver lane resolved once for the stack (the JAX package's
    ``solver=`` jit key) and pinned on this thread, so the step the card
    captures runs one lane whatever the process setting does meanwhile."""
    from spark_gp_tpu_torch.obs import trace as obs_trace

    name = "fit.device" if mesh is None else "fit.device.sharded"
    with obs_trace.span(name), it_ops.solver_lane_scope(it_ops.resolve_for(data)):
        yield


def check_capturable(mesh, data: ExpertData, capture: bool = True) -> None:
    """Raise :class:`~spark_gp_tpu_torch.parallel.mesh.MeshCaptureError` for
    a sharded device fit on the card whose collectives cannot ride the
    captured step (a gloo collective synchronizes with the host)."""
    if mesh is None or not data.x.is_cuda or not capture or mesh.capturable:
        return
    from spark_gp_tpu_torch.parallel.mesh import MeshCaptureError

    raise MeshCaptureError(
        f"a sharded device fit on the card needs collectives a CUDA graph can "
        f"capture; the {mesh.backend!r} group's synchronize with the host "
        "(use an NCCL group, or setOptimizer('host'))")


def fit_gpr_device(kernel: Kernel, log_space: bool, theta0, lower, upper, data: ExpertData,
                   max_iter: int, tol: float, extra=(), cache=None, objective="marginal",
                   capture: bool = True, loop_metrics=None, mesh=None):
    """The single-start device fit: the objective and the box L-BFGS-B loop
    on the stack's device, replayed from one captured CUDA graph on the
    card (``optimize/lbfgs_device.py``).  ``theta0``, ``lower``, ``upper``
    are tensors in the stack's dtype and device.  Returns device tensors
    ``(theta, f, n_iter, n_fev, stalled)``, theta in linear coordinates.

    With ``mesh``, every rank runs the same loop on its own block ``data``
    (``cache`` and the weights of ``extra`` its blocks; no jitter operand
    rides a sharded fit), and the step's one all-reduce of value and
    gradient sits inside the captured CUDA graph, so an evaluation costs
    one collective and no host sync (the JAX package's whole-loop
    ``shard_map``).  The communicator exists by then: the fit's initial
    evaluation, which runs eagerly, makes the group's first collective.
    NCCL only on the card (:func:`check_capturable`); on the CPU the same
    step runs eagerly, as every device fit there.  The results are the
    same on every rank."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import lbfgs_minimize_device, log_reparam

    if mesh is not None:
        check_capturable(mesh, data, capture)
    vag = make_device_value_and_grad(kernel, data, cache, objective, extra, mesh)
    from_u = (lambda t: t)
    if log_space:
        vag, theta0, lower, upper, from_u = log_reparam(vag, theta0, lower, upper)
    with _device_fit_scope(data, mesh):
        theta, f, n_iter, n_fev, stalled = lbfgs_minimize_device(
            vag, theta0, lower, upper, max_iter=max_iter, tol=tol, capture=capture,
            loop_metrics=loop_metrics)
    return from_u(theta), f, n_iter, n_fev, stalled


def fit_gpr_device_sharded(kernel: Kernel, mesh, log_space: bool, theta0, lower, upper,
                           data: ExpertData, max_iter: int, tol: float, cache=None,
                           objective="marginal", weights=None, capture: bool = True,
                           loop_metrics=None):
    """The JAX package's sharded device fit under its name:
    :func:`fit_gpr_device` over ``mesh`` with the aggregation ``weights``
    (this rank's block) as its only operand."""
    extra = () if weights is None or objective != "marginal" else (None, weights)
    return fit_gpr_device(kernel, log_space, theta0, lower, upper, data, max_iter, tol, extra,
                          cache, objective, capture=capture, loop_metrics=loop_metrics,
                          mesh=mesh)


def fit_gpr_device_multistart(kernel: Kernel, log_space: bool, theta0_batch, lower, upper,
                              data: ExpertData, max_iter: int, tol: float, extra=(), cache=None,
                              objective="marginal", loop_metrics=None, mesh=None):
    """All R restarts as one lockstep device loop, every evaluation one
    pass over the R lanes (one K1 launch over their ``[R * E, s, s]``
    stacks); the gram cache is shared by the lanes.  Returns
    ``(theta_best, f_best, n_iter, n_fev, stalled, f_all [R], best)``."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import multistart_minimize

    if mesh is not None:
        check_capturable(mesh, data)
    vag = make_device_value_and_grad(kernel, data, cache, objective, extra, mesh)
    with _device_fit_scope(data, mesh):
        return multistart_minimize(vag, log_space, theta0_batch, lower, upper, max_iter, tol,
                                   loop_metrics=loop_metrics)


def fit_gpr_device_checkpointed(kernel: Kernel, log_space: bool, theta0, lower, upper,
                                data: ExpertData, max_iter: int, tol: float, chunk: int, saver,
                                objective: str = "marginal", extra=(), cache=None,
                                loop_metrics=None, mesh=None):
    """The device fit in ``chunk``-iteration segments with the full
    optimizer state persisted through ``saver`` between them
    (``utils/checkpoint.run_segmented``); a checkpoint of the same fit
    (the JAX package's resume meta: objective, kernel, tol,
    parameterization, start, stack shapes and data fingerprint) resumes
    it without the initial evaluation.  Returns ``(theta, f, n_iter,
    n_fev, stalled)``."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import (
        LbfgsConfig,
        log_transform_bounds,
        log_transform_vag,
    )
    from spark_gp_tpu_torch.utils.checkpoint import run_segmented, segment_meta

    family = "gpr" if objective == "marginal" else f"gpr-{objective}"
    extra_meta = {
        f"objective_extra_{i}": (
            [] if e is None else [float(v) for v in np.asarray(
                e.detach().cpu().numpy() if isinstance(e, torch.Tensor) else e).ravel()]
        )
        for i, e in enumerate(extra)
    }
    # tol as the stack's dtype holds it, as the JAX package records it
    tol_meta = float(torch.tensor(tol, dtype=data.x.dtype))
    meta = segment_meta(family, kernel, tol_meta, log_space, theta0, data.x, data.y, data.mask,
                        mesh=mesh, **extra_meta)
    if mesh is not None:
        check_capturable(mesh, data)
    vag = make_device_value_and_grad(kernel, data, cache, objective, extra, mesh)
    if log_space:
        vag = log_transform_vag(vag)
        lower, upper = log_transform_bounds(lower, upper)
        start = torch.log(theta0)
    else:
        start = theta0
    cfg = LbfgsConfig(lower=lower, upper=upper, tol=float(tol))
    with _device_fit_scope(data, mesh):
        state = run_segmented(vag, start, cfg, saver, meta, max_iter, chunk,
                              loop_metrics=loop_metrics)
    theta = torch.exp(state["theta"][0]) if log_space else state["theta"][0]
    return theta, state["f"][0], state["n_iter"][0], state["n_fev"][0], state["stalled"][0]
