"""Degradation ladder: classified execution failures and policy-driven
fallback re-execution (the port's copy of the JAX package's
``resilience/fallback.py``).

* a **closed failure taxonomy** (:data:`FAILURE_CLASSES`, the JAX
  package's) and :func:`classify_failure`, which maps an exception into
  it by TYPE first: the port's own kernel failures
  (``KernelBuildError``, ``KernelLaunchError``) and a device optimizer
  step that could not be captured (``GraphCaptureError``) are
  ``unknown`` before any message is read, so no text that nvcc or the
  driver put into them can make the ladder degrade -- and so route
  around -- a kernel or the captured loop;
  ``torch.cuda.OutOfMemoryError``, ``MemoryError`` and the caching
  allocator's "CUDA out of memory" are ``oom``;
* **declarative ladders** per entry point (:data:`LADDERS`): a classified
  failure re-executes the work one rung down.  Fit: ``native`` ->
  ``iterative`` -> ``matfree`` (the solver lanes, ``ops/iterative.py``)
  -> ``segmented`` (the device optimizer's fit -- regression, the Laplace
  classifiers, the count models -- in segments of half the
  checkpoint interval, with an in-memory saver) -> ``host_f64`` (the
  same fit with float64 operands ON THE CARD, under the host optimizer);
  the solver rungs apply to host and device-optimizer fits alike (the
  device loop runs on every lane); a fit-time precision guard breach
  under ``GP_GUARD_ACTION=degrade`` (:class:`GuardBreachError`) takes the
  ``strict_lane`` rung, the same fit pinned to the strict precision lane
  on its thread.  No rung moves a fit to the CPU.  With a
  device budget, the memory planner picks the starting rung of a
  device-optimizer fit (``memplan.plan_fit_dispatch``).  Predict: chunk halving
  on OOM, then the last rung (the JAX package's ``host_solve``), which
  runs the request one row at a time in float64 on its own device.
  Every transition is counted
  (``fallback.*``), is a span event, lands in the run journal and on the
  model (``degradations``); ``GP_FALLBACK=0`` restores raw propagation;
* the **single-classified-error guarantee**: an exhausted ladder raises
  ONE :class:`DegradationExhaustedError` naming the class and the rung
  history, the last failure chained.

* the magic solve's ladder (:func:`run_ppa_solve_ladder`):
  ``device_solve`` -> ``host_solve`` on an OOM or compile failure.

* the ``fit_distributed`` ladder (:func:`run_distributed_ladder`):
  ``sharded`` -> ``dcn_fallback`` -> ``single_host`` on an OOM or compile
  failure, and ``strict_lane`` on a guard breach.  ``dcn_fallback``
  re-runs the fit in the key-value-store mode (``parallel/coord.py``:
  every cross-rank sum a round over the group's store, not over the
  process group whose step failed) where ``coord.dcn_fallback_available``
  allows it (several processes, a reachable store, the fit not in the
  mode already) and every rank votes for it in one store round
  (``coord.ranks_agree``); ``single_host`` is legal only where this rank holds
  every row (a mesh of one rank, and never a store-mode stack of
  several).  A ``CoordinationTimeoutError`` is ``coord_timeout``: it
  takes the same rungs, and a rank that is gone cannot vote, so over
  several ranks the vote's own deadline raises naming it.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Callable, List, Optional

logger = logging.getLogger("spark_gp_tpu_torch")

# --------------------------------------------------------------------------
# the closed taxonomy
# --------------------------------------------------------------------------

#: device/host allocation failure (the caching allocator's OOM)
OOM = "oom"
#: compilation or lowering failure of something that is not one of the
#: port's kernels (those are ``unknown``, see classify_failure)
COMPILE = "compile"
#: non-finite objective the per-expert recovery could not attribute/repair
NON_FINITE_EXHAUSTED = "non_finite_exhausted"
#: a factorization that exhausted the adaptive jitter ladder
NOT_PSD_EXHAUSTED = "not_psd_exhausted"
#: a deadline-guarded multi-host coordination step timed out
COORD_TIMEOUT = "coord_timeout"
#: fit-time mixed-precision guard breached its lane bar (GP_GUARD_ACTION)
GUARD_BREACH = "guard_breach"
#: silent data corruption caught by the integrity plane
SDC = "sdc"
#: everything else -- NEVER degraded, always re-raised raw
UNKNOWN = "unknown"

FAILURE_CLASSES = (
    OOM, COMPILE, NON_FINITE_EXHAUSTED, NOT_PSD_EXHAUSTED,
    COORD_TIMEOUT, GUARD_BREACH, SDC, UNKNOWN,
)

#: message fragments identifying an allocation failure in a RuntimeError
_OOM_MARKERS = (
    "resource_exhausted", "out of memory", "attempting to allocate",
    "allocation failure",
)
#: message fragments identifying a compilation/lowering failure
_COMPILE_MARKERS = (
    "compilation failure", "failed to compile", "compile failed",
    "mosaic", "lowering failed", "internal: during compilation",
    "xla compilation",
)


class GuardBreachError(RuntimeError):
    """A non-strict precision lane breached its accuracy bar at fit time
    (``models/common._emit_precision_guard``) under
    ``GP_GUARD_ACTION=degrade``: the ladder turns it into a strict-lane
    re-fit."""

    def __init__(self, lane: str, worst: float, bar: float):
        super().__init__(
            f"mixed_precision_guard: lane {lane!r} deviates {worst:.3e} "
            f"from strict (bar {bar:.1e}) and GP_GUARD_ACTION=degrade "
            "requested a strict-lane re-fit"
        )
        self.lane = lane
        self.worst = float(worst)
        self.bar = float(bar)


class DegradationExhaustedError(RuntimeError):
    """Every applicable rung failed: the ONE classified error the caller
    sees (cause chained to the last underlying failure).  ``degradations``
    is the full transition history, ``failure_class`` the final class."""

    def __init__(self, entry: str, failure_class: str, degradations: list,
                 cause: BaseException):
        rungs = " -> ".join(
            [degradations[0]["from"]] + [d["to"] for d in degradations]
        ) if degradations else "(none)"
        super().__init__(
            f"{entry}: degradation ladder exhausted "
            f"(final failure class {failure_class!r}, rungs {rungs}): {cause}"
        )
        self.entry = entry
        self.failure_class = failure_class
        self.degradations = list(degradations)


def enabled() -> bool:
    """The kill switch: ``GP_FALLBACK=0`` restores raw propagation."""
    return os.environ.get("GP_FALLBACK", "").strip().lower() not in ("0", "false", "off")


def classify_failure(exc: BaseException) -> str:
    """Map an exception into the closed taxonomy, by type first, then (for
    runtime-shaped errors of no known type) by message; anything
    unrecognized is :data:`UNKNOWN`, which the ladder never degrades."""
    import torch

    from spark_gp_tpu_torch.ops.cuda_lib import (
        GraphCaptureError,
        KernelBuildError,
        KernelLaunchError,
    )
    from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException
    from spark_gp_tpu_torch.resilience.quarantine import (
        ExpertQuarantineError,
        NonFiniteFitError,
    )
    from spark_gp_tpu_torch.resilience.retry import RetryBudgetExceededError

    if isinstance(exc, (KernelBuildError, KernelLaunchError, GraphCaptureError)):
        # a failure of one of the port's own kernels, or of the capture of
        # the loop that launches them: degrading it would finish the fit
        # without them, whatever its text says
        return UNKNOWN
    if isinstance(exc, DegradationExhaustedError):
        return exc.failure_class
    if isinstance(exc, GuardBreachError):
        return GUARD_BREACH
    from spark_gp_tpu_torch.resilience.integrity import IntegrityError

    if isinstance(exc, IntegrityError):
        return SDC
    if isinstance(exc, NotPositiveDefiniteException):
        return NOT_PSD_EXHAUSTED
    if isinstance(exc, (NonFiniteFitError, ExpertQuarantineError)):
        return NON_FINITE_EXHAUSTED
    if isinstance(exc, RetryBudgetExceededError) and exc.__cause__ is not None:
        return classify_failure(exc.__cause__)
    from spark_gp_tpu_torch.parallel.coord import CoordinationTimeoutError

    if isinstance(exc, CoordinationTimeoutError):
        return COORD_TIMEOUT
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return OOM
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        if any(marker in msg for marker in _OOM_MARKERS):
            return OOM
        if any(marker in msg for marker in _COMPILE_MARKERS):
            return COMPILE
    return UNKNOWN


# --------------------------------------------------------------------------
# metering
# --------------------------------------------------------------------------


def record_failure(exc: BaseException, entry: str) -> str:
    """Classify and count one observed failure (``fallback.failures.*``),
    relayed into the flight recorder; returns the class."""
    cls = classify_failure(exc)
    from spark_gp_tpu_torch.obs.recorder import RECORDER
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc(f"fallback.failures.{cls}", entry=entry)
    RECORDER.record(
        "fallback.failure", entry=entry, failure_class=cls,
        error=f"{type(exc).__name__}: {exc}"[:200],
    )
    return cls


def _record_transition(entry: str, cls: str, from_rung: str, to_rung: str,
                       exc: BaseException, instr=None) -> dict:
    from spark_gp_tpu_torch.obs import trace as obs_trace
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc("fallback.transitions", entry=entry)
    telemetry.inc(f"fallback.rung.{to_rung}", entry=entry)
    obs_trace.add_event(
        "fallback.engaged",
        entry=entry, failure_class=cls, from_rung=from_rung, to_rung=to_rung,
    )
    message = (
        f"degradation ladder [{entry}]: {cls} at rung {from_rung!r} — "
        f"re-executing at rung {to_rung!r} ({type(exc).__name__}: "
        f"{str(exc)[:200]})"
    )
    if instr is not None:
        instr.log_warning(message)
    else:
        logger.warning("%s", message)
    return {
        "entry": entry,
        "failure_class": cls,
        "from": from_rung,
        "to": to_rung,
        "error": f"{type(exc).__name__}: {exc}"[:200],
    }


def _stamp(instr, model, degradations: List[dict]) -> None:
    """Attach the transition history to the fit's metrics
    (``fallback.engaged``; the estimators' ``model.metrics`` is
    ``instr.metrics``), its instr (the run journal) and the model."""
    instr.degradations = list(degradations)
    instr.log_metric("fallback.engaged", 1.0)
    model.degradations = list(degradations)


# --------------------------------------------------------------------------
# the declarative ladders
# --------------------------------------------------------------------------

#: rung order per entry point (the JAX package's)
LADDERS = {
    "fit": (
        "native", "iterative", "matfree", "segmented", "host_f64",
        "strict_lane",
    ),
    "fit_sharded": ("sharded", "dcn_fallback", "single_host", "strict_lane"),
    "predict": ("chunked", "chunk_halved", "host_solve"),
    "ppa": ("device_solve", "host_solve"),
}

#: per-class candidate rungs at the ``fit`` entry, in order: an OOM tries
#: the iterative solver lane first (the factorization workspace replaced
#: by skinny CG state), then the matrix-free lane (no gram stack at all),
#: and only then the float64 re-run
_FIT_POLICY = {
    OOM: ("iterative", "matfree", "segmented", "host_f64"),
    COMPILE: ("segmented", "host_f64"),
    NON_FINITE_EXHAUSTED: ("host_f64",),
    NOT_PSD_EXHAUSTED: ("host_f64",),
    GUARD_BREACH: ("strict_lane",),
}

#: classes the sharded-fit ladder degrades (everything else re-raises)
_SHARDED_POLICY = (OOM, COMPILE, COORD_TIMEOUT)

#: bounded chunk halvings before the predict ladder's last rung
MAX_PREDICT_HALVINGS = 8


def fallback_segment_chunk(checkpoint_interval: int) -> int:
    """The ``segmented`` rung's segment: half the configured checkpoint
    interval (``setCheckpointInterval``, default 10)."""
    return max(1, int(checkpoint_interval) // 2)


class NullSegmentSaver:
    """The ``segmented`` rung's in-memory saver: the device fit's segment
    loop without persisted state (the fit asked for no checkpoint
    directory)."""

    path = None

    def load(self, template, meta: dict):
        return None

    def save(self, state, meta: dict) -> None:
        pass


def _fit_rung_applies(est, rung: str, cls: str, visited, data=None) -> bool:
    """Whether ``rung`` is a legal next step for this estimator and class.
    ``data`` (the fit's expert stack) lets the solver rungs resolve an
    ``auto`` lane and ``host_f64`` see the working dtype."""
    if rung in visited:
        return False
    if rung in ("iterative", "matfree"):
        from spark_gp_tpu_torch.kernels.base import supports_matfree
        from spark_gp_tpu_torch.ops.iterative import active_solver_lane, resolve_solver

        if rung == "matfree" and not supports_matfree(est._get_kernel()):
            # a kernel that cannot stream would re-run the materialized
            # iterative program: same bytes, same OOM
            return False
        lane = active_solver_lane()
        if data is not None:
            e, s, p = (int(d) for d in data.x.shape)
            return resolve_solver(s, lane, num_experts=e, n_features=p,
                                  itemsize=data.x.element_size()) != rung
        return lane != rung
    if rung == "host_f64":
        if cls in (NON_FINITE_EXHAUSTED, NOT_PSD_EXHAUSTED):
            # numerical exhaustion degrades only where the rung ADDS
            # precision: a fit whose working dtype is already float64 (the
            # CPU harness) keeps raising the reference's advice
            return data is not None and data.x.element_size() < 8
        return True
    if rung == "segmented":
        # the plain single-start device fit: a checkpointed fit is already
        # segmented, and the batched multi-start has no segment driver
        return (
            est._checkpoint_dir is None
            and est._num_restarts == 1
            and est._resolved_optimizer() == "device"
        )
    if rung == "strict_lane":
        from spark_gp_tpu_torch.ops.precision import active_lane

        return active_lane() != "strict"
    return False


def _next_fit_rung(est, cls: str, visited, data=None) -> Optional[str]:
    for rung in _FIT_POLICY.get(cls, ()):
        if _fit_rung_applies(est, rung, cls, visited, data):
            return rung
    return None


@contextlib.contextmanager
def _fit_rung_scope(est, rung: str):
    """Bind one rung's overrides for the span of an attempt: the solver
    rungs pin this thread's lane (``solver_lane_scope``, which outranks a
    caller's own scope outside it and leaves other threads' fits alone),
    ``strict_lane`` this thread's precision lane (``precision_lane_scope``),
    ``segmented`` and ``host_f64`` set ``est._fallback_mode``
    (``common._fallback_segmented``, ``common._host_f64_operands``)."""
    if rung == "native":
        yield
        return
    if rung == "strict_lane":
        from spark_gp_tpu_torch.ops.precision import precision_lane_scope

        with precision_lane_scope("strict"):
            yield
        return
    if rung in ("iterative", "matfree"):
        from spark_gp_tpu_torch.ops.iterative import solver_lane_scope

        with solver_lane_scope(rung):
            yield
        return
    prev_mode = getattr(est, "_fallback_mode", None)
    est._fallback_mode = rung
    try:
        yield
    finally:
        est._fallback_mode = prev_mode


def run_fit_ladder(est, instr, attempt: Callable, data=None):
    """The fit entry point's ladder driver around the complete attempt
    (which runs the per-expert numerical recovery inside; the ladder sees
    only what that layer could not repair).  ``data`` (the expert stack)
    lets the rung gates resolve the lanes.  With a device budget the
    memory planner picks a device-optimizer fit's starting rung
    (``memplan.plan_fit_dispatch``: ``native`` or the pre-sized
    ``segmented``); a failure despite a plan that admitted it counts
    ``plan.miss``, and the ladder degrades as without one."""
    if not enabled():
        return attempt()
    from spark_gp_tpu_torch.resilience import memplan

    plan = memplan.plan_fit_dispatch(est, instr, data)
    rung = "native" if plan is None else plan.chosen
    visited = {"native", rung}
    degradations: List[dict] = []
    plan_missed = False
    while True:
        try:
            with _fit_rung_scope(est, rung):
                model = attempt()
        except Exception as exc:  # classified-failure-site: taxonomy dispatch
            cls = record_failure(exc, entry="fit")
            if plan is not None and plan.fits and not plan_missed and cls == OOM:
                plan_missed = True
                memplan.record_plan_miss("fit")
            nxt = _next_fit_rung(est, cls, visited, data)
            if nxt is None:
                if degradations:
                    from spark_gp_tpu_torch.obs.runtime import telemetry

                    telemetry.inc("fallback.exhausted", entry="fit")
                    raise DegradationExhaustedError("fit", cls, degradations, exc) from exc
                raise  # nothing engaged: raw propagation
            degradations.append(_record_transition("fit", cls, rung, nxt, exc, instr))
            visited.add(nxt)
            rung = nxt
            continue
        if degradations:
            _stamp(instr, model, degradations)
        return model


def run_distributed_ladder(est, instr, data, active_set, prepare):
    """The ``fit_distributed`` ladder (the JAX package's): ``sharded`` runs
    the fit over the mesh; an OOM or compile failure re-runs it as
    ``dcn_fallback`` -- the same body in the key-value-store mode -- where
    ``coord.dcn_fallback_available`` allows and every rank's failure takes
    the rung (one vote over the store, cast by every failing rank), else
    (and after it) as
    ``single_host`` -- the same body over the same stack with no mesh --
    only where this rank's stack is the whole data (a mesh of one rank): a
    rank that re-fit its block alone would return a model of a fragment.
    A guard breach re-runs it ``strict_lane``.  Every transition is
    recorded as in the fit ladder; ``GP_FALLBACK=0`` runs the body
    straight."""
    if not enabled():
        return est._fit_distributed_body(instr, data, active_set, prepare)
    from spark_gp_tpu_torch.ops.precision import active_lane, precision_lane_scope
    from spark_gp_tpu_torch.parallel import coord

    degradations: List[dict] = []
    rung = "sharded"

    def whole_here() -> bool:
        # a store-mode stack of several ranks is 1/P of the data: re-fitting
        # it alone would be the wrong-results bug the ladder must not make
        ctx = getattr(est, "_dcn_ctx", None)
        if ctx is not None:
            return ctx.num_processes <= 1
        mesh = getattr(est, "_mesh", None)
        return mesh is None or mesh.world_size == 1

    while True:
        try:
            if rung == "strict_lane":
                with precision_lane_scope("strict"):
                    model = est._fit_distributed_body(instr, data, active_set, prepare)
            elif rung == "single_host":
                mesh_prev, est._mesh = est._mesh, None
                try:
                    model = est._fit_distributed_body(instr, data, active_set, prepare)
                finally:
                    est._mesh = mesh_prev
            elif rung == "dcn_fallback":
                with est._dcn_bound(coord.store_context()):
                    model = est._fit_distributed_body(instr, data, active_set, prepare)
            else:
                model = est._fit_distributed_body(instr, data, active_set, prepare)
        except Exception as exc:  # classified-failure-site: taxonomy dispatch
            cls = record_failure(exc, entry="fit_sharded")
            nxt = None
            if cls == GUARD_BREACH and rung != "strict_lane" and active_lane() != "strict":
                nxt = "strict_lane"
            elif rung == "sharded" and coord.dcn_fallback_available(
                    getattr(est, "_dcn_ctx", None)):
                # every failing rank votes, so the ranks take the rung together
                if coord.ranks_agree("dcn_fallback", cls in _SHARDED_POLICY):
                    nxt = "dcn_fallback"
                elif cls in _SHARDED_POLICY and whole_here():
                    nxt = "single_host"
            elif cls in _SHARDED_POLICY and rung == "sharded" and whole_here():
                nxt = "single_host"
            elif cls in _SHARDED_POLICY and rung == "dcn_fallback" and whole_here():
                nxt = "single_host"
            if nxt is None:
                if degradations:
                    from spark_gp_tpu_torch.obs.runtime import telemetry

                    telemetry.inc("fallback.exhausted", entry="fit_sharded")
                    raise DegradationExhaustedError("fit_sharded", cls, degradations,
                                                    exc) from exc
                raise
            degradations.append(_record_transition("fit_sharded", cls, rung, nxt, exc, instr))
            rung = nxt
            continue
        if degradations:
            _stamp(getattr(model, "instr", None) or instr, model, degradations)
        return model


def _dump_predict_incident(exc: BaseException, cls: str, degradations: List[dict]) -> None:
    """Terminal predict failures bundle here (fits bundle in
    ``common._observed_fit``): one bundle per terminal classified failure."""
    if cls == UNKNOWN and not isinstance(exc, DegradationExhaustedError):
        return
    from spark_gp_tpu_torch.obs import recorder as obs_recorder
    from spark_gp_tpu_torch.obs import trace as obs_trace

    current = obs_trace.current_span()
    obs_recorder.dump_incident(
        reason="predict", exc=exc, failure_class=cls,
        root=getattr(current, "root_span", None),
        extra={"degradations": list(degradations)},
    )


def run_predict_ladder(attempt_at_chunk: Callable[[int], object],
                       last_attempt: Callable[[], object], chunk: int,
                       planned: bool = False):
    """The predict entry point's ladder (``models/ppa.py``): an OOM on a
    chunked dispatch halves the chunk (at most
    :data:`MAX_PREDICT_HALVINGS` times) and re-dispatches the whole
    request; a chunk that cannot shrink under the ceiling, or a compile
    failure, falls to ``last_attempt`` (the rung keeps the JAX package's
    name, ``host_solve``; the predictor runs it on the request's device).  ``planned`` marks a chunk
    the memory plan admitted (an OOM despite it counts ``plan.miss``).
    Each transition is a ``fallback.engaged`` event in the flight
    recorder (and the current span), and a ``fallback.rung.*`` count."""
    if not enabled():
        return attempt_at_chunk(chunk)
    degradations: List[dict] = []
    halvings = 0
    plan_missed = False

    def transition(cls, from_rung, to_rung, exc):
        degradations.append(_record_transition("predict", cls, from_rung, to_rung, exc))

    while True:
        try:
            return attempt_at_chunk(chunk)
        except Exception as exc:  # classified-failure-site: taxonomy dispatch
            cls = record_failure(exc, entry="predict")
            if planned and not plan_missed and cls == OOM:
                from spark_gp_tpu_torch.resilience import memplan

                plan_missed = True
                memplan.record_plan_miss("predict")
            if cls == OOM and chunk > 1 and halvings < MAX_PREDICT_HALVINGS:
                transition(cls, f"chunk_{chunk}", f"chunk_{chunk // 2}", exc)
                chunk //= 2
                halvings += 1
                continue
            if cls in (OOM, COMPILE):
                transition(cls, f"chunk_{chunk}" if halvings else "chunked", "host_solve", exc)
                try:
                    return last_attempt()
                except Exception as host_exc:  # classified-failure-site
                    from spark_gp_tpu_torch.obs.runtime import telemetry

                    telemetry.inc("fallback.exhausted", entry="predict")
                    err = DegradationExhaustedError(
                        "predict", classify_failure(host_exc), degradations, host_exc)
                    _dump_predict_incident(err, err.failure_class, degradations)
                    raise err from host_exc
            if degradations:
                from spark_gp_tpu_torch.obs.runtime import telemetry

                telemetry.inc("fallback.exhausted", entry="predict")
                err = DegradationExhaustedError("predict", cls, degradations, exc)
                _dump_predict_incident(err, cls, degradations)
                raise err from exc
            _dump_predict_incident(exc, cls, degradations)
            raise


def run_ppa_solve_ladder(device_attempt: Callable, host_attempt: Callable, mesh=None):
    """The magic solve's ladder (``models/ppa.magic_solve``): an OOM or a
    compile failure of the device float64 solve re-runs the same solve on
    the host (``device_solve`` -> ``host_solve``, counted).  Anything else,
    ``NotPositiveDefiniteException`` among it, is re-raised as it was: the
    ladder changes where the solve runs, never the jitter policy.

    Over a ``mesh`` of several ranks no rank takes the host rung: a rank
    whose sharded solve failed midway cannot rejoin its peers' collectives
    to agree on a verdict, so its failure propagates (the multi-rank rule
    of the fit's recovery, ``models/common._run_with_expert_resilience``).
    A staged fault at the solve's choke point fires before any collective,
    on every rank that staged it; a real one on one rank leaves its peers
    to the group's timeout, which raises on them."""
    if not enabled() or (mesh is not None and mesh.world_size > 1):
        return device_attempt()
    try:
        return device_attempt()
    except Exception as exc:  # classified-failure-site: taxonomy dispatch
        cls = record_failure(exc, entry="ppa")
        if cls not in (OOM, COMPILE):
            raise
        _record_transition("ppa", cls, "device_solve", "host_solve", exc)
        return host_attempt()
