"""Predictive memory planning (the port's copy of the JAX package's
``resilience/memplan.py``).

Decisions made BEFORE a dispatch, from a byte model of the port's eager
programs against the device budget:

* **budget** -- :func:`memory_budget_bytes`: a staged chaos limit
  (``chaos.memory_limit_bytes``) > ``GP_MEMPLAN_LIMIT_BYTES`` > the
  card's own budget, its total memory times the per-process fraction in
  force (``torch.cuda.get_per_process_memory_fraction``), read from the
  process's current CUDA device.  No CUDA context (the CPU) means no
  budget, and no budget means no plan constraint.
* **prediction** -- :func:`fit_dispatch_bytes` models one objective
  evaluation of a fit on each rung, :func:`predict_dispatch_bytes` one
  PPA predict chunk; :func:`predicted_bytes` applies the margin
  (:data:`MARGIN`), and :func:`observe_measured`
  ratchets a model up whenever a measured peak (the caching allocator's
  ``max_memory_allocated``) exceeds it; with cost metering on, the
  dispatch sites arm the loop (:func:`note_expected_dispatch`) and the
  metered per-execution peak closes it (:func:`note_compiled_peak`).
* **decision** -- :func:`plan_dispatch`: candidates preferred-first, the
  first predicted-safe one wins.  Consumers: ``ops/iterative.resolve_solver``
  (the budget-aware ``auto`` lane), the PPA predict chunk
  (:func:`plan_predict_chunk`), the serve admission gate
  (:func:`predict_request_bytes` against :func:`memory_in_use_bytes`),
  and the fit's starting rung (:func:`plan_fit_dispatch`, the device
  optimizer's fits only).  The reactive ladder
  (``resilience/fallback.py``) stays the backstop: an OOM despite a plan
  counts ``plan.miss``.

``GP_MEMPLAN=0`` turns planning off.  Metrics: ``plan.hit`` /
``plan.miss`` / ``plan.margin_breach`` (``obs/names.py``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: gram-sized ``[E, s, s]`` buffers live at once during one objective
#: evaluation, beyond the theta-invariant cache, per rung -- derived from
#: the peaks of one evaluation measured on an H100 (the ``memplan`` phase
#: of chip_smoke.py): the exact lane 8.2 and 9.1 gram stacks above its
#: operands at (14, 97) (K1) and (9, 4065) (cuSOLVER); the iterative
#: lane's materialized gram, its jittered copy and the autograd residuals
#: of its two differentiated products ~6.9.  ``host_f64`` is the exact lane in float64 (callers pass
#: ``itemsize=8``); ``matfree`` builds no gram.  ``segmented`` is the
#: device optimizer's fit in segments: the same captured step as its
#: one-shot fit, so the same evaluation's buffers (its calibration key is
#: its own, so a measured one-shot peak above the model leaves the
#: segmented rung's prediction, and the planner may start there).
_FIT_RUNG_WORK_FACTOR = {
    "native": 9.0,
    "segmented": 9.0,
    "host_f64": 9.0,
    "iterative": 6.5,
    "matfree": 0.0,
}
#: ``[E, s, rank + 5 (1 + probes)]``-sized skinny buffers live at once on
#: the solver lanes (preconditioner, multi-RHS CG block and carries, SLQ
#: recurrences), from the same measurements: ~12 on the iterative lane
#: (its autograd keeps per-step state), ~2 on the matfree lane.
_FIT_RUNG_SKINNY_FACTOR = {"iterative": 13.0, "matfree": 2.5}
#: a Laplace family's device step on a CG rung (its B systems are
#: materialized on both): gram-sized work buffers besides the gram (the
#: binary classifier's gradient pass solves B for all s columns of its
#: inverse, ~17 measured; the multiclass factored operator and the count
#: models' single solves ~3) and skinny buffers (~3-19 measured), from one
#: step's peak on the CPU at (4, 100) and (2, 300), the kernels' own
#: buffers left out (``tests/test_torch_memplan.py``); the card's step at
#: the configs' shapes is chip_smoke.py's memplan-device line
_CG_LATENT_WORK = {"GaussianProcessClassifier": 18.0}
_CG_LATENT_WORK_DEFAULT = 3.0
_CG_LATENT_SKINNY = 16.0


#: the safety margin multiplied into every prediction (the JAX package's
#: default)
MARGIN = 1.25


def enabled() -> bool:
    """The kill switch, read at call time: ``GP_MEMPLAN`` (default on --
    inert without a budget)."""
    return os.environ.get("GP_MEMPLAN", "").strip().lower() not in ("0", "false", "off")


def card_budget_bytes() -> Optional[float]:
    """The current CUDA device's budget: total memory times the
    per-process fraction in force; None where this process holds no CUDA
    context (creating one just to plan would be a side effect)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    dev = torch.cuda.current_device()
    total = torch.cuda.get_device_properties(dev).total_memory
    return float(total) * float(torch.cuda.get_per_process_memory_fraction(dev))


def memory_budget_bytes() -> Optional[float]:
    """The device memory ceiling the planner budgets against, or None:
    staged chaos limit > ``GP_MEMPLAN_LIMIT_BYTES`` > the card's budget."""
    from spark_gp_tpu_torch.resilience import chaos

    staged = chaos.staged_memory_limit()
    if staged is not None:
        return float(staged)
    raw = os.environ.get("GP_MEMPLAN_LIMIT_BYTES", "").strip()
    if raw:
        try:
            value = float(raw)
            return value if value > 0 else None
        except ValueError:
            pass
    return card_budget_bytes()


# --------------------------------------------------------------------------
# the byte models (raw -- no margin; callers apply predicted_bytes)
# --------------------------------------------------------------------------


def fit_model_key(family: Optional[str], rung: str) -> Tuple:
    """The calibration key of one fit model: per family and per rung."""
    return ("fit", family, rung)


def predict_model_key(mean_only: bool) -> Tuple:
    return ("predict", bool(mean_only))


def fit_dispatch_bytes(
    num_experts: int,
    expert_size: int,
    n_features: int,
    itemsize: int,
    rung: str = "native",
    n_targets: int = 1,
    family: Optional[str] = None,
    latent_heads: int = 0,
) -> float:
    """Modeled RAW peak bytes of one objective evaluation at ``rung``: the
    expert stack (``[E, s, p]`` features, targets and mask), the
    theta-invariant gram cache plus ``k`` gram-sized work buffers (the
    lane's :data:`_FIT_RUNG_WORK_FACTOR`, times heads squared: the
    multiclass Laplace crosses every latent-head pair), and on the solver
    lanes the skinny ``[E, s, rank + 5 (1 + probes)]`` buffers.  The
    matfree lane has no gram term, not even the cache, which that lane
    never builds.  A device fit of a Laplace family (``latent_heads`` > 0:
    1, or the class count of the multiclass fit) adds the per-lane latent
    stacks it carries (the modes, the kept trial's and the Newton carry:
    three ``[E, s, heads]``) and, on the exact rungs, the B stack one
    Newton iteration factors with its inverse (two ``[E * heads, s, s]``);
    on the CG rungs (iterative, and matfree, where the B systems are
    materialized too) its step holds the gram, the B stack and the solves'
    work (:data:`_CG_LATENT_WORK` gram-sized buffers a ``family``) beside
    the PCG state, the pivoted-Cholesky panel and the fit's probes
    (:data:`_CG_LATENT_SKINNY` skinny ``[E, s, rank + 5 (1 + probes)]``
    buffers).  A regression device step holds what an evaluation does
    (the L-BFGS state is ``[R, m, h]``).  A cost model, not an
    accounting identity: calibration
    (:func:`observe_measured`) raises it where a measurement proves it
    low, and the margin covers the rest."""
    from spark_gp_tpu_torch.ops.iterative import solver_config

    e = float(max(1, num_experts))
    s = float(max(1, expert_size))
    p = float(max(1, n_features))
    heads = float(max(1, n_targets))
    stack = e * s * (p + 2.0 * heads) * itemsize
    gram = e * s * s * itemsize
    raw = stack
    if latent_heads and rung in ("iterative", "matfree"):
        cfg = solver_config(int(s))
        work = _CG_LATENT_WORK.get(family, _CG_LATENT_WORK_DEFAULT)
        raw += (1.0 + work) * gram + 3.0 * e * s * float(latent_heads) * itemsize
        raw += _CG_LATENT_SKINNY * e * s * (cfg.rank + 5.0 * (1.0 + cfg.probes)) * itemsize
        return _calibrated(fit_model_key(family, rung), raw)
    if rung != "matfree":
        k = _FIT_RUNG_WORK_FACTOR.get(rung, _FIT_RUNG_WORK_FACTOR["native"])
        raw += (1.0 + k * heads * heads) * gram
    if latent_heads:
        lat = float(latent_heads)
        raw += (3.0 * e * s * lat + 2.0 * e * lat * s * s) * itemsize
    skinny = _FIT_RUNG_SKINNY_FACTOR.get(rung)
    if skinny:
        cfg = solver_config(int(s))
        raw += skinny * e * s * (cfg.rank + 5.0 * (1.0 + cfg.probes)) * heads * itemsize
    return _calibrated(fit_model_key(family, rung), raw)


def predict_dispatch_bytes(rows: int, m: int, n_features: int, itemsize: int,
                           mean_only: bool = False) -> float:
    """Modeled RAW peak bytes of one PPA predict chunk of ``rows`` test
    points against an ``m``-point active set: four ``[rows, m]`` cross
    sized buffers, the ``[m, m]`` magic matrix (variance models),
    operands and outputs (the JAX package's model)."""
    r = float(max(1, rows))
    m_f = float(max(1, m))
    p = float(max(1, n_features))
    cross = 4.0 * r * m_f
    operators = m_f + (0.0 if mean_only else m_f * m_f)
    io = r * p + m_f * p + (1.0 if mean_only else 2.0) * r
    return _calibrated(predict_model_key(mean_only), (cross + operators + io) * itemsize)


def predicted_bytes(raw: float) -> float:
    """A raw model estimate with the safety margin applied: THE number
    compared against budgets."""
    return float(raw) * MARGIN


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------

_LOCK = threading.Lock()
#: model key -> multiplicative scale (>1 only), for the process life
_CALIBRATION: Dict[Tuple, float] = {}
#: entry name -> the largest metered per-execution peak seen
#: (``obs/cost.py``: ``max_memory_allocated`` over the first execution of
#: a signature, less the allocation at entry)
_COMPILED_PEAKS: Dict[str, float] = {}
#: the calibration loop's armed dispatch: the dispatch sites
#: (``models/common._dispatch_raw_bytes``, the PPA predict chunk) deposit
#: (model key, raw model bytes) just before dispatching; the metered peak
#: relayed from the same thread right after the dispatch closes the loop
_EXPECT = threading.local()


def _calibrated(key: Tuple, raw: float) -> float:
    with _LOCK:
        scale = _CALIBRATION.get(key, 1.0)
    return raw * scale


def observe_measured(key: Tuple, raw_model_bytes: float, measured_bytes: float) -> None:
    """Calibrate a model from a measured peak: when reality exceeds the
    model, the key's scale ratchets up so the NEXT prediction brackets
    it.  Never ratchets down."""
    if raw_model_bytes <= 0 or measured_bytes <= 0:
        return
    scale = measured_bytes / raw_model_bytes
    if scale <= 1.0:
        return
    with _LOCK:
        if scale > _CALIBRATION.get(key, 1.0):
            _CALIBRATION[key] = scale


def note_expected_dispatch(key: Tuple, raw_bytes: float) -> None:
    """Arm the calibration loop for the dispatch about to run: when cost
    metering relays its measured peak, the model under ``key`` is judged
    against it (:func:`observe_measured`).  Overwritten by the next
    dispatch; consumed at most once."""
    _EXPECT.pending = (key, float(raw_bytes))


def note_compiled_peak(entry: str, peak_bytes: float) -> None:
    """Record one entry point's metered per-execution peak (fed by
    ``obs/cost.py`` whenever metering measures on the card) and close the
    calibration loop against the armed dispatch when its kind matches
    the entry's (a fit model by a ``fit.`` entry, a predict model by a
    ``predict.`` or ``serve.`` entry, so a stale expectation is never
    consumed by another kind)."""
    if not peak_bytes or peak_bytes <= 0:
        return
    with _LOCK:
        if peak_bytes > _COMPILED_PEAKS.get(entry, 0.0):
            _COMPILED_PEAKS[entry] = float(peak_bytes)
    pending = getattr(_EXPECT, "pending", None)
    if pending is None:
        return
    key, raw = pending
    kind = key[0]
    if (kind == "fit" and entry.startswith("fit.")) or (
            kind == "predict" and entry.startswith(("predict.", "serve."))):
        _EXPECT.pending = None
        observe_measured(key, raw, float(peak_bytes))


def compiled_peak(entry: str) -> Optional[float]:
    """The largest metered peak of ``entry``, or None when never metered."""
    with _LOCK:
        return _COMPILED_PEAKS.get(entry)


def compiled_peaks() -> Dict[str, float]:
    with _LOCK:
        return dict(_COMPILED_PEAKS)


def calibration_scale(key: Tuple) -> float:
    """The scale calibration has applied to ``key``'s model (1 = none)."""
    with _LOCK:
        return _CALIBRATION.get(key, 1.0)


def reset_calibration() -> None:
    """Drop the calibration state and the metered peaks."""
    with _LOCK:
        _CALIBRATION.clear()
        _COMPILED_PEAKS.clear()


# --------------------------------------------------------------------------
# plan_dispatch -- THE decision API
# --------------------------------------------------------------------------


@dataclass
class PlanDecision:
    """One admission decision: the largest predicted-safe candidate."""

    entry: str
    chosen: str
    raw_bytes: float            # modeled actual of the chosen config
    predicted_bytes: float      # raw * margin -- the budgeted number
    budget_bytes: Optional[float]
    fits: bool                  # False: NOTHING fit; chosen = smallest
    margin: float = MARGIN
    candidates: List[dict] = field(default_factory=list)

    def row(self) -> dict:
        """The provenance row journals and bundles carry (json-safe)."""
        return {
            "entry": self.entry,
            "chosen": self.chosen,
            "raw_bytes": self.raw_bytes,
            "predicted_bytes": self.predicted_bytes,
            "budget_bytes": self.budget_bytes,
            "fits": self.fits,
            "margin": self.margin,
            "candidates": list(self.candidates),
        }


def plan_dispatch(entry: str, candidates: Sequence[Tuple[str, float]],
                  budget: Optional[float] = None) -> Optional[PlanDecision]:
    """Pick the first candidate (preferred-first ``(name, raw_bytes)``)
    whose margined prediction fits the budget; a ``fits=False`` decision
    on the smallest-predicted candidate when none does.  None when
    planning is off or no budget resolves."""
    if not enabled() or not candidates:
        return None
    if budget is None:
        budget = memory_budget_bytes()
    if budget is None:
        return None
    rows = [
        {
            "name": name,
            "raw_bytes": float(raw),
            "predicted_bytes": predicted_bytes(raw),
            "fits": predicted_bytes(raw) <= budget,
        }
        for name, raw in candidates
    ]
    chosen = next((r for r in rows if r["fits"]), min(rows, key=lambda r: r["predicted_bytes"]))
    decision = PlanDecision(
        entry=entry,
        chosen=chosen["name"],
        raw_bytes=chosen["raw_bytes"],
        predicted_bytes=chosen["predicted_bytes"],
        budget_bytes=float(budget),
        fits=bool(chosen["fits"]),
        candidates=rows,
    )
    from spark_gp_tpu_torch.obs import trace as obs_trace
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc("plan.hit" if decision.fits else "plan.miss", entry=entry)
    obs_trace.add_event(
        "plan.decision",
        entry=entry, chosen=decision.chosen, fits=decision.fits,
        predicted_bytes=decision.predicted_bytes, budget_bytes=decision.budget_bytes,
    )
    return decision


def record_plan_miss(entry: str) -> None:
    """A reactive recovery engaged DESPITE a plan decision: counted."""
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc("plan.miss", entry=entry)


def stamp_decision(instr, decision: Optional[PlanDecision]) -> None:
    """Attach a decision row to the instr the run journal (and any
    incident bundle) is assembled from: the ``memory_plan`` key."""
    if decision is None or instr is None:
        return
    instr.memory_plan = list(getattr(instr, "memory_plan", []) or []) + [decision.row()]


# --------------------------------------------------------------------------
# consumers
# --------------------------------------------------------------------------


def fit_rung_of_lane(resolved: str, streams: bool) -> str:
    """The byte-model rung of a resolved solver lane: ``native`` for the
    exact lane; the matfree lane only for a kernel that streams (others
    run the materialized iterative program and are priced as it)."""
    if resolved == "matfree":
        return "matfree" if streams else "iterative"
    return "iterative" if resolved == "iterative" else "native"


def plan_fit_dispatch(est, instr, data) -> Optional[PlanDecision]:
    """The fit's starting rung, planned before the first attempt (called by
    ``fallback.run_fit_ladder``): ``native`` (the one-shot device fit)
    preferred, the ladder's ``segmented`` rung as the pre-sized
    alternative where it applies (``fallback._fit_rung_applies``).  Only
    the device optimizer's fits are planned (the host optimizer's
    per-evaluation work is the same on every rung it has); None -- no
    constraint -- for them, without a stack, or without a budget."""
    if not enabled() or data is None:
        return None
    if est._resolved_optimizer() != "device" or getattr(est, "_mesh", None) is not None:
        # a sharded dispatch is not planned (the JAX package's rule: no
        # model of a rank's footprint yet)
        return None
    budget = memory_budget_bytes()
    if budget is None:
        return None
    e, s, p = (int(d) for d in data.x.shape)
    itemsize = data.x.element_size()
    family = type(est).__name__
    heads = est._device_latent_heads()
    candidates = [("native", fit_dispatch_bytes(e, s, p, itemsize, "native", 1, family, heads))]
    from spark_gp_tpu_torch.resilience import fallback

    if fallback._fit_rung_applies(est, "segmented", fallback.OOM, set(), data):
        candidates.append(
            ("segmented", fit_dispatch_bytes(e, s, p, itemsize, "segmented", 1, family, heads)))
    decision = plan_dispatch("fit", candidates, budget)
    stamp_decision(instr, decision)
    return decision


def plan_predict_chunk(chunk: int, m: int, n_features: int, itemsize: int,
                       mean_only: bool) -> Optional[int]:
    """The PPA predict chunk, pre-sized: the largest chunk (halving down
    from ``chunk``, as many times as the reactive ladder may halve) whose
    margined prediction fits the budget.  None when planning is off or
    no budget resolves (the caller keeps its chunk); 1 when even the
    smallest does not fit (the ladder backstops)."""
    if not enabled() or chunk <= 1:
        return None
    budget = memory_budget_bytes()
    if budget is None:
        return None
    from spark_gp_tpu_torch.resilience.fallback import MAX_PREDICT_HALVINGS

    candidates = []
    c = int(chunk)
    for _ in range(MAX_PREDICT_HALVINGS + 1):
        candidates.append((str(c), predict_dispatch_bytes(c, m, n_features, itemsize, mean_only)))
        if c <= 1:
            break
        c //= 2
    decision = plan_dispatch("predict", candidates, budget)
    if decision is None:
        return None
    planned = int(decision.chosen) if decision.fits else 1
    return max(1, min(chunk, planned))


def predict_request_bytes(predictor, rows: int) -> Optional[float]:
    """Margined predicted bytes of one serve request of ``rows`` against a
    ``serve/batcher.BucketedPredictor``, sized at the padded bucket shape
    (the dispatch that will run): the cost the admission gate compares
    with the remaining headroom.  None when planning is off or the
    predictor does not expose its shape."""
    if not enabled():
        return None
    try:
        padded = int(predictor.padded_rows(int(rows)))
        m = int(predictor.active_rows)
        p = int(predictor.n_features)
        itemsize = 8  # the predict block's cross kernel is float64
        mean_only = bool(predictor.mean_only)
    except Exception:  # noqa: BLE001 -- no shape, no prediction: the gate
        # keeps its watermark hysteresis
        return None
    return predicted_bytes(predict_dispatch_bytes(padded, m, p, itemsize, mean_only))


def memory_in_use_bytes() -> Optional[float]:
    """Bytes in use now, the serve admission gate's usage read: the
    caching allocator's ``memory_allocated`` where this process holds a
    CUDA context, else the current host RSS (``/proc/self/statm``), else
    the host's peak RSS as the last resort."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return float(torch.cuda.memory_allocated())
    try:
        with open("/proc/self/statm", encoding="ascii") as fh:
            rss_pages = int(fh.read().split()[1])
        return float(rss_pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    except (ImportError, OSError):
        return None
