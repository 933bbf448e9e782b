"""The device fits of the Laplace families: the binary classifier
(``models/laplace.py``), the softmax multiclass classifier
(``models/laplace_mc.py``) and the generic-likelihood core of the count
models (``models/laplace_generic.py``), run by the on-device L-BFGS-B
(``optimize/lbfgs_device.py``) as *latent objectives*.

The three share one structure, so one class carries it:
:class:`LaplaceLanes` evaluates R lanes of theta at once over the
``[R, E, s, ...]`` latent stacks, with the families' Newton proposal, inner
objective and converged-state gradient pass as hooks.

* :meth:`LaplaceLanes.trial` is what the captured step runs: the lanes'
  grams at the trial theta, ``newton_k`` unrolled Newton iterations from
  the carried Newton state -- each the host loop's body over the
  flattened ``[R * E]`` stack, masked per expert and per lane, so one K1
  launch factors every lane's B (or B_c) stack -- then the gradient pass
  at the modes reached.  No host read: a lane whose Newton loop has not
  ended is reported unfinished and its Newton state carried to the next
  step (:mod:`~spark_gp_tpu_torch.optimize.lbfgs_device`).
* :meth:`LaplaceLanes.evaluate` is one whole evaluation, eagerly, the
  Newton loop ending on a host read per iteration: the fit's initial
  evaluation and the warm-up before a capture.
* ``newton_k`` (:func:`newton_k`: :data:`NEWTON_K` per family, with
  :data:`NEWTON_K_CG`'s entries on the CG lanes) is the Newton iterations
  of a step; it changes how many steps a trial takes, never the iterates.
* the solver lane resolves once a fit, when the lanes are made, and every
  evaluation runs on it; on the CG lanes (``ops/iterative.py``: a fixed
  PCG trip count, converged columns masked) the B systems' probes are
  drawn at the fit's first evaluation and kept (``ops.iterative.ProbeSet``,
  one ``[E]`` draw shared by the R lanes, as the JAX package's vmapped
  lanes share it).

The fit drivers (:func:`fit_latent_device`,
:func:`fit_latent_device_multistart`, :func:`fit_latent_device_checkpointed`)
are the JAX package's ``fit_*_device``, ``fit_*_device_multistart`` and
``fit_*_device_checkpointed`` for any family; each family module names
them after its JAX counterparts.  EP's sweeps ride the same drivers
(``models/ep.EPLanes``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack
from spark_gp_tpu_torch.ops import iterative as it_ops

#: Newton iterations a captured step holds, per family: the Newton
#: iterations an evaluation takes on the card, rounded up (PERF.md §5:
#: 2.76 binary, 5.77 multiclass, 25.6 / 25.9 Poisson / NB, half a trial
#: a step for the last; EP's site sweeps, 7.4 a trial on the host path)
NEWTON_K = {"gpc": 3, "gpc_mc": 6, "generic": 13, "ep": 8}
#: where the iterative and matfree lanes differ from :data:`NEWTON_K`, by
#: the same rule (the device fit's Newton iterations an evaluation there,
#: rounded up: 2.25 binary, 3.98 multiclass, 26.1 Poisson; PERF.md §5).
#: Each Newton iteration holds a rank-64 pivoted Cholesky and a 64-step
#: PCG (~2,200 graph nodes at s = 100), the gradient pass five PCGs more,
#: and every replay runs the pass, masked or not: one iteration a step
#: made Poisson's fit 3,440 replays of a 21,707-node step, 170 s
NEWTON_K_CG = {"gpc_mc": 4}


def newton_k(family: str, cg: bool) -> int:
    """The Newton iterations (EP: site sweeps) a captured step holds for
    ``family``, on a CG lane if ``cg``."""
    return int((NEWTON_K_CG if cg else {}).get(family, NEWTON_K[family]))


def newton_start(f0):
    """``(old, new, step)`` of a Newton loop from ``f0`` (``[B, s, ...]``):
    the reference's initial ``old = -inf``, ``new = finfo.min`` and ``step
    = 1`` per expert."""
    lead, dtype, dev = f0.shape[:1], f0.dtype, f0.device
    return (torch.full(lead, -math.inf, dtype=dtype, device=dev),
            torch.full(lead, torch.finfo(dtype).min, dtype=dtype, device=dev),
            torch.ones(lead, dtype=dtype, device=dev))


def newton_running(old, new, step, tol):
    """The experts whose Newton loop goes on: ``|old - new| > tol and step
    > tol`` (GPClf.scala:91-111)."""
    return (torch.abs(old - new) > tol) & (step > tol)


def newton_update(proposal, inner_objective, kmat, y, mask, f, old, new, step, run):
    """One Newton iteration of a flat ``[B]`` expert stack for the experts
    in ``run``, every family's loop body: the step from ``proposal(kmat, y,
    mask, f) -> (a, K a)`` at the expert's step length, accepted iff its
    ``inner_objective(a, f_cand, y, mask)`` beats ``old``, else the step
    halves; the other experts keep their state."""
    a, f_prop = proposal(kmat, y, mask, f)
    sv = step.view((-1,) + (1,) * (f.dim() - 1))
    f_cand = (1.0 - sv) * f + sv * f_prop
    obj_cand = inner_objective(a, f_cand, y, mask)
    accept = obj_cand > old
    upd = run & accept
    f = torch.where(upd.view(sv.shape), f_cand, f)
    old, new = torch.where(upd, new, old), torch.where(upd, obj_cand, new)
    step = torch.where(run & ~accept, step / 2.0, step)
    return f, old, new, step


class LaplaceLanes:
    """R lanes of a Laplace objective for the device optimizer (module
    doc).  ``y`` is the stack's targets (``[E, s]``, or ``[E, s, C]`` one-hot
    for the multiclass family) and ``mask`` its ``[E, s]`` row mask;
    ``passes`` is the K1 calls of one gradient pass.  Subclasses give
    :attr:`mode_loop`, :meth:`_proposal`, :meth:`_inner_objective` and
    :meth:`_gradient_pass`."""

    family = ""
    passes = 1
    #: the family's host Newton loop ``(*mode_args, kmat, y, mask, f0, tol)
    #: -> (modes, inner objectives)`` (one host read an iteration), which
    #: keeps its Newton iterations in its ``iterations`` counter
    mode_loop = None
    mode_args: tuple = ()

    def __init__(self, kernel: Kernel, x, y, mask, tol: float, cache=None) -> None:
        self.kernel, self.x, self.y, self.mask = kernel, x, y, mask
        self.tol = float(tol)
        self.cache = cache
        e, s, p = (int(d) for d in x.shape)
        #: the fit's solver lane, resolved once (the JAX ``solver=`` key)
        self.lane = it_ops.resolve_solver(s, num_experts=e, n_features=p,
                                          itemsize=x.element_size())
        cg = self.lane in ("iterative", "matfree")
        self.newton_k = newton_k(self.family, cg)
        #: the CG lanes' probes, drawn at the first evaluation and kept
        self.probes = it_ops.ProbeSet(experts=e)
        self._lanes: Dict[int, tuple] = {}
        #: Newton iterations and evaluations run eagerly (:meth:`evaluate`)
        self.eager_iterations = 0
        self.eager_evaluations = 0

    # --- the families' hooks ----------------------------------------------
    def _proposal(self, kmat, y, mask, f):
        """``(a, f')``: the Newton step's ``a`` and the full step's latent
        ``f' = K a`` from ``f``, for a flat ``[B, s, s]`` stack."""
        raise NotImplementedError

    def _inner_objective(self, a, f_cand, y, mask):
        """The step-acceptance objective ``[B]`` at ``f_cand``."""
        raise NotImplementedError

    def _gradient_pass(self, thetas, f, new_obj):
        """``(values [R], grads [R, h])`` at the converged modes ``f``
        (``[R, E, ...]``) with their inner objectives ``new_obj`` ``[R, E]``:
        ``-sum_e log Z_e`` of each lane and its gradient."""
        raise NotImplementedError

    # --- shared -------------------------------------------------------------
    @contextlib.contextmanager
    def scope(self):
        """The fit's lane and probes around an evaluation."""
        with it_ops.solver_lane_scope(self.lane), it_ops.probe_scope(self.probes):
            yield

    def lane_targets(self, r: int):
        """``(y, mask)`` repeated over ``r`` lanes, flat ``[r * E, ...]``
        (kept, so a captured step reads the same buffers every replay)."""
        got = self._lanes.get(r)
        if got is None:
            rep = (r,) + (1,) * (self.y.dim() - 1)
            got = (self.y.repeat(rep), self.mask.repeat(r, 1))
            self._lanes[r] = got
        return got

    def aux0(self, r: int):
        """The zero latent stacks ``[r, E, s, ...]`` a fit starts from."""
        return torch.zeros((r,) + tuple(self.y.shape), dtype=self.x.dtype, device=self.x.device)

    def lane_grams(self, thetas, grad: bool = False):
        """``[R * E, s, s]``: the masked gram stacks of the lanes' thetas
        (with the fit's gram cache), lane after lane; ``grad`` records
        theta's graph."""
        s = self.x.shape[1]
        with torch.set_grad_enabled(grad):
            return torch.stack([masked_gram_stack(self.kernel, thetas[r], self.x, self.mask,
                                                  self.cache)
                                for r in range(thetas.shape[0])]).reshape(-1, s, s)

    def reset(self, aux) -> Dict[str, torch.Tensor]:
        """The Newton state of a trial that starts from the modes ``aux``
        (``[R, E, ...]``): :func:`newton_start` per expert."""
        r, e = aux.shape[:2]
        old, new, step = newton_start(aux.reshape((r * e,) + tuple(aux.shape[2:])))
        return {"nt_f": aux.clone(), "nt_old": old.reshape(r, e), "nt_new": new.reshape(r, e),
                "nt_step": step.reshape(r, e)}

    @torch.no_grad()
    def trial(self, thetas, carry, run):
        """The captured step's evaluation (module doc): ``(values [R],
        grads [R, h], carry, finished [R], worked)``, ``worked`` the
        unrolled iterations in which some expert ran (an int32 device
        scalar).  ``run`` ``[R]`` masks the lanes that evaluate."""
        with self.scope():
            return self._trial(thetas, carry, run)

    def _trial(self, thetas, carry, run):
        r, e = carry["nt_old"].shape
        kmat = self.lane_grams(thetas)
        y, mask = self.lane_targets(r)
        f = carry["nt_f"].reshape((r * e,) + tuple(carry["nt_f"].shape[2:]))
        old, new, step = (carry[k].reshape(-1) for k in ("nt_old", "nt_new", "nt_step"))
        lane_run = run[:, None].expand(r, e).reshape(-1)
        worked = torch.zeros((), dtype=torch.int32, device=f.device)
        for _ in range(self.newton_k):
            going = newton_running(old, new, step, self.tol) & lane_run
            worked = worked + going.any().to(torch.int32)
            f, old, new, step = newton_update(self._proposal, self._inner_objective, kmat, y,
                                              mask, f, old, new, step, going)
        finished = ~(newton_running(old, new, step, self.tol) & lane_run).reshape(r, e).any(-1)
        f = f.reshape(carry["nt_f"].shape)
        new_re = new.reshape(r, e)
        values, grads = self._gradient_pass(thetas, f, new_re)
        out = {"nt_f": f, "nt_old": old.reshape(r, e), "nt_new": new_re,
               "nt_step": step.reshape(r, e)}
        return values, grads, out, finished, worked

    @torch.no_grad()
    def evaluate(self, thetas, aux):
        """One whole evaluation of every lane from the modes ``aux``,
        eagerly, through the family's host Newton loop (which ends on a host
        read per iteration): ``(values [R], grads [R, h], modes [R, E,
        ...])``."""
        with self.scope():
            return self._evaluate(thetas, aux)

    def _evaluate(self, thetas, aux):
        r, e = aux.shape[:2]
        y, mask = self.lane_targets(r)
        before = self.mode_loop.iterations
        f, new = self.mode_loop(*self.mode_args, self.lane_grams(thetas), y, mask,
                                aux.reshape((r * e,) + tuple(aux.shape[2:])), self.tol)
        self.eager_iterations += self.mode_loop.iterations - before
        self.eager_evaluations += 1
        f = f.reshape(aux.shape)
        values, grads = self._gradient_pass(thetas, f, new.reshape(r, e))
        return values, grads, f


class ShardedLanes:
    """A latent objective's lanes over a mesh (the JAX package's
    ``_segment_vag(mesh)`` and sharded device fits): this rank's
    ``lanes`` run their Newton iterations (EP: site sweeps) on its own
    block, its latent modes and Newton state stay on the rank, and each
    evaluation all-reduces ``[values, grads, unfinished]`` ``[R, 1 + h +
    1]`` once on the device, so a captured step holds one collective a
    replay whatever the Newton loop does (its iterations are unrolled and
    masked).  A lane is finished when every rank's block finished it.  The
    Newton iterations counted (``worked``, the eager counts) are this
    rank's own: each rank's loop stops on its own experts."""

    def __init__(self, lanes: LaplaceLanes, mesh) -> None:
        from spark_gp_tpu_torch.optimize.lbfgs_device import carry_fields

        self.lanes, self.mesh = lanes, mesh
        self.carry_fields = carry_fields(lanes)

    def trial(self, thetas, carry, run):
        values, grads, carry, finished, worked = self.lanes.trial(thetas, carry, run)
        flat = self.mesh.all_reduce(torch.cat(
            [values[:, None], grads, (~finished).to(values.dtype)[:, None]], dim=1))
        return flat[:, 0], flat[:, 1:-1], carry, flat[:, -1] == 0, worked

    def evaluate(self, thetas, aux):
        values, grads, aux = self.lanes.evaluate(thetas, aux)
        flat = self.mesh.all_reduce(torch.cat([values[:, None], grads], dim=1))
        return flat[:, 0], flat[:, 1:], aux

    def reset(self, aux):
        return self.lanes.reset(aux)


def over_mesh(lanes: LaplaceLanes, mesh, capture: bool = True):
    """``lanes`` summed over ``mesh`` (:class:`ShardedLanes`), or as they are
    without one; a gloo group on the card raises ``MeshCaptureError``
    (``likelihood.check_capturable``) before anything runs."""
    if mesh is None:
        return lanes
    from spark_gp_tpu_torch.models.likelihood import check_capturable

    check_capturable(mesh, lanes, capture)
    return ShardedLanes(lanes, mesh)


# --- the fit drivers -------------------------------------------------------------


def _device_fit_scope(mesh=None):
    """The ``fit.device`` span (``fit.device.sharded`` over a mesh) around
    a device fit."""
    from spark_gp_tpu_torch.obs import trace as obs_trace

    return obs_trace.span("fit.device" if mesh is None else "fit.device.sharded")


def _add_eager_counts(lanes: LaplaceLanes, loop_metrics) -> None:
    """The fit's Newton iterations and gradient passes in
    ``loop_metrics``: the device counts plus the eager evaluations' (the
    initial one, a resumed leg's warm-up), which are also kept apart, with
    the step's Newton iterations and the K1 calls of a gradient pass."""
    if loop_metrics is not None:
        loop_metrics["newton_iterations"] = (loop_metrics.get("newton_iterations", 0)
                                             + lanes.eager_iterations)
        loop_metrics["gradient_passes"] = (loop_metrics.get("gradient_passes", 0)
                                           + lanes.eager_evaluations)
        loop_metrics.update(eager_newton_iterations=lanes.eager_iterations,
                            eager_evaluations=lanes.eager_evaluations,
                            newton_k=lanes.newton_k, pass_k1_calls=lanes.passes)


def fit_latent_device(lanes: LaplaceLanes, log_space: bool, theta0, lower, upper, max_iter: int,
                      tol: float, capture: bool = True, loop_metrics=None, mesh=None):
    """The single-start device fit of a Laplace family from zero latents:
    ``(theta, f_latents [E, s, ...], nll, n_iter, n_fev, stalled)`` as
    device tensors, theta in linear coordinates, the latents the modes at
    the last accepted iterate (JAX ``fit_gpc_device``).  With ``mesh``,
    ``lanes`` hold this rank's block and the fit is the sharded one
    (:class:`ShardedLanes`, JAX ``fit_gpc_device_sharded``): every rank runs
    the same loop, the latents returned are its block's, and the rest is
    the same on every rank."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import lbfgs_run_lanes, log_reparam

    vag, from_u = over_mesh(lanes, mesh, capture), (lambda t: t)
    if log_space:
        vag, theta0, lower, upper, from_u = log_reparam(vag, theta0, lower, upper)
    with _device_fit_scope(mesh):
        st = lbfgs_run_lanes(vag, theta0[None], lower, upper, max_iter=max_iter, tol=tol,
                             capture=capture, loop_metrics=loop_metrics, aux0=lanes.aux0(1))
    _add_eager_counts(lanes, loop_metrics)
    return (from_u(st["theta"][0]), st["aux"][0], st["f"][0], st["n_iter"][0], st["n_fev"][0],
            st["stalled"][0])


def fit_latent_device_multistart(lanes: LaplaceLanes, log_space: bool, theta0_batch, lower,
                                 upper, max_iter: int, tol: float, loop_metrics=None, mesh=None):
    """All R restarts as one lockstep device loop, every trial's Newton
    iterations one K1 launch over the R lanes' stacks; the lanes start from
    zero latents each (JAX ``fit_gpc_device_multistart``).  Returns
    ``(theta_best, f_latents_best, nll_best, n_iter, n_fev, stalled,
    f_all [R], best)``: the lowest finite final objective wins.  ``mesh``:
    as for :func:`fit_latent_device`."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import lbfgs_run_lanes, log_reparam

    vag, from_u = over_mesh(lanes, mesh), (lambda t: t)
    if log_space:
        vag, theta0_batch, lower, upper, from_u = log_reparam(vag, theta0_batch, lower, upper)
    r = theta0_batch.shape[0]
    with _device_fit_scope(mesh):
        st = lbfgs_run_lanes(vag, theta0_batch, lower, upper, max_iter=max_iter, tol=tol,
                             loop_metrics=loop_metrics, aux0=lanes.aux0(r))
    _add_eager_counts(lanes, loop_metrics)
    fs = st["f"]
    best = torch.argmin(torch.where(torch.isfinite(fs), fs, torch.full_like(fs, math.inf)))
    return (from_u(st["theta"][best]), st["aux"][best], fs[best], st["n_iter"][best],
            st["n_fev"][best], st["stalled"][best], fs, best)


def fit_latent_device_checkpointed(lanes: LaplaceLanes, kind: str, log_space: bool, theta0,
                                   lower, upper, max_iter: int, tol: float, chunk: int, saver,
                                   loop_metrics=None, mesh=None, **meta_extra):
    """The device fit in ``chunk``-iteration segments with the full
    optimizer state, the latent modes included, persisted through
    ``saver`` (``utils/checkpoint.run_segmented``); a resume continues
    from the saved modes.  ``kind`` and ``meta_extra`` are the JAX
    package's ``segment_meta`` kind and extras.  Returns the single-start
    fit's tuple.  ``mesh``: as for :func:`fit_latent_device`; under a mesh
    the meta is the whole stack's (``utils/checkpoint.segment_meta``) and
    ``saver`` the coordinated shell (``parallel/coord.py``)."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import (
        LbfgsConfig,
        log_transform_bounds,
        log_transform_vag,
    )
    from spark_gp_tpu_torch.resilience.chaos import SimulatedPreemption
    from spark_gp_tpu_torch.utils.checkpoint import run_segmented, segment_meta

    # tol as the stack's dtype holds it, as the JAX package records it
    tol_meta = float(torch.tensor(tol, dtype=lanes.x.dtype))
    meta = segment_meta(kind, lanes.kernel, tol_meta, log_space, theta0, lanes.x, lanes.y,
                        lanes.mask, mesh=mesh, **meta_extra)
    vag, start = over_mesh(lanes, mesh), theta0
    if log_space:
        vag = log_transform_vag(vag)
        lower, upper = log_transform_bounds(lower, upper)
        start = torch.log(theta0)
    cfg = LbfgsConfig(lower=lower, upper=upper, tol=float(tol))
    with _device_fit_scope(mesh):
        try:
            st = run_segmented(vag, start, cfg, saver, meta, max_iter, chunk,
                               loop_metrics=loop_metrics, aux0=lanes.aux0(1))
        except SimulatedPreemption as exc:
            # the preempted leg's record, its eager evaluation included
            _add_eager_counts(lanes, loop_metrics)
            if loop_metrics is not None:
                exc.loop_metrics = loop_metrics
            raise
    _add_eager_counts(lanes, loop_metrics)
    theta = torch.exp(st["theta"][0]) if log_space else st["theta"][0]
    return theta, st["aux"][0], st["f"][0], st["n_iter"][0], st["n_fev"][0], st["stalled"][0]
