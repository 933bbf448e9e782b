"""Runtime telemetry: kernel builds and launches, memory, the run journal
(the port's counterpart of the JAX package's ``obs/runtime.py``).

* **kernel counting** -- in place of the JAX package's ``jax.monitoring``
  compile counting: every ``nvcc`` build of a kernel source counts
  ``kernel.builds.<name>`` (``ops/cuda_lib.py``) and every launch by a
  kernel's wrapper ``kernel.launches.<name>`` (``ops/spd_linalg.py``,
  ``ops/streamed_matvec.py``), each attributed to the ACTIVE TRACE ROOT
  (``fit.GaussianProcessRegression``, ...).  A count is a host dict
  update: no device read, no sync;
* **memory gauges** -- ``torch.cuda.memory_stats()`` sampled at phase
  boundaries into ``memory.bytes_in_use`` / ``memory.peak_bytes_in_use``
  (allocated now and at peak) and ``memory.bytes_reserved`` (held by the
  caching allocator); the host peak RSS where no CUDA context exists;
* **cost** -- with metering on (``obs/cost.py``, ``GP_XLA_COST``) the
  active fit capture keeps a per-entry table of metered executions
  (:meth:`FitCapture.note_xla_cost`), from which the journal's
  ``xla_cost`` block and the memory plan's ``compiled_peak_bytes`` come;
* **run journal** -- every fit is stamped with a ``run_journal`` dict
  (span tree, lanes, quarantine events, degradations, memory plan,
  kernel builds and launches, memory samples, the fit-time
  ``expert_quality`` table, ``xla_cost``), persisted as JSON when
  ``GP_RUN_JOURNAL_DIR`` names a directory.

All keys are registered in :mod:`spark_gp_tpu_torch.obs.names`.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

from spark_gp_tpu_torch.obs import trace as _trace
from spark_gp_tpu_torch.obs.recorder import write_json_atomic

logger = logging.getLogger("spark_gp_tpu_torch")

_UNTRACED = "untraced"
_KERNEL_PREFIXES = ("kernel.builds.", "kernel.launches.")


class RuntimeTelemetry:
    """Process-global counters and gauges, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        # counter key -> {entry point -> count}; entry = active trace root
        self.per_entry: Dict[str, Dict[str, float]] = {}
        self.gauges: Dict[str, float] = {}
        # the host-RSS read is throttled: many boundaries of a tiny fit
        # fall within one interval
        self._rss_at = 0.0
        self._rss = None

    def inc(self, key: str, entry: Optional[str] = None, n: float = 1.0) -> None:
        if entry is None:
            entry = _trace.current_root_name() or _UNTRACED
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + n
            by = self.per_entry.setdefault(key, {})
            by[entry] = by.get(entry, 0.0) + n

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = float(value)

    def sample_memory(self) -> Dict[str, float]:
        """One sample of the card's allocator (the host peak RSS where this
        process holds no CUDA context).  Reads the caching allocator's own
        counters: no device sync.  Returns the raw sample; only the
        process-global gauges keep the maximum of ``*peak*`` keys."""
        import torch

        sample: Dict[str, float] = {}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # the allocator's nested stats, unflattened: one C call
            stats = torch.cuda.memory_stats_as_nested_dict(torch.cuda.current_device())
            allocated = stats.get("allocated_bytes", {}).get("all", {})
            sample["memory.bytes_in_use"] = float(allocated.get("current", 0))
            sample["memory.peak_bytes_in_use"] = float(allocated.get("peak", 0))
            sample["memory.bytes_reserved"] = float(
                stats.get("reserved_bytes", {}).get("all", {}).get("current", 0))
        else:
            now = time.monotonic()
            if self._rss is None or now - self._rss_at > 0.02:
                import resource

                # ru_maxrss is KiB on Linux
                self._rss = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
                self._rss_at = now
            sample["memory.host_peak_rss_bytes"] = self._rss
        with self._lock:
            for key, value in sample.items():
                if "peak" in key:
                    value = max(value, self.gauges.get(key, 0.0))
                self.gauges[key] = value
        return sample

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "per_entry": {k: dict(v) for k, v in self.per_entry.items()},
                "gauges": dict(self.gauges),
            }


#: the process singleton every hook feeds
telemetry = RuntimeTelemetry()


def kernel_counts(counters: Dict[str, float],
                  base: Optional[Dict[str, float]] = None) -> Dict[str, Dict[str, float]]:
    """``{"builds": {kernel: n}, "launches": {kernel: n}}`` from telemetry
    counters, less ``base`` when given (a fit's deltas)."""
    base = base or {}
    out: Dict[str, Dict[str, float]] = {"builds": {}, "launches": {}}
    for key, value in counters.items():
        for prefix, section in zip(_KERNEL_PREFIXES, ("builds", "launches")):
            if key.startswith(prefix):
                delta = value - base.get(key, 0.0)
                if delta:
                    out[section][key[len(prefix):]] = delta
    return out


def build_info() -> Dict[str, object]:
    """The ``gp_build_info`` identity: package, torch and CUDA versions,
    the card (when a CUDA context exists), precision lane, process count."""
    import torch

    from spark_gp_tpu_torch.ops.precision import active_lane

    info: Dict[str, object] = {
        "package": "spark_gp_tpu_torch",
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": "cpu",
        "process_count": 1,
        "precision_lane": active_lane(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        info["backend"] = torch.cuda.get_device_name(torch.cuda.current_device())
    return info


# -- the fit's trace id ------------------------------------------------------

_trace_token: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "gp_obs_trace_token", default=None
)


def new_trace_token() -> str:
    """A fresh trace id for one fit (the JAX package's local token)."""
    return f"t-{uuid.uuid4().hex[:16]}"


def active_trace_token() -> Optional[str]:
    """The trace id of the enclosing fit (None outside one)."""
    return _trace_token.get()


@contextlib.contextmanager
def trace_token_scope(token: Optional[str]):
    """Bind the trace id for the span of one fit."""
    ctx_token = _trace_token.set(token)
    try:
        yield token
    finally:
        _trace_token.reset(ctx_token)


# -- per-fit capture ---------------------------------------------------------

_active_capture: contextvars.ContextVar[Optional["FitCapture"]] = (
    contextvars.ContextVar("gp_obs_fit_capture", default=None)
)


class FitCapture:
    """Kernel-count deltas and memory samples bracketing one fit (the run
    journal's inputs).  Deltas are of the process-global counters: two
    fits racing in separate threads may cross-attribute each other's
    launches in the totals; ``kernels["by_entry"]`` follows each launch's
    own trace root."""

    def __init__(self, name: str):
        self.name = name
        snap = telemetry.snapshot()
        self._base = dict(snap["counters"])
        self._base_entry = {k: dict(v) for k, v in snap["per_entry"].items()}
        self.memory_samples: List[dict] = []
        self.kernels: Dict[str, Dict] = {"builds": {}, "launches": {}, "by_entry": {}}
        # entry -> {flops_per_execution, bytes_per_execution, executions,
        # kernels}, fed by obs/cost.py while this capture is active
        self.xla_costs: Dict[str, Dict] = {}
        self._finished = False

    def add_memory_sample(self, tag: str) -> None:
        sample = telemetry.sample_memory()
        if sample:
            self.memory_samples.append({"phase": tag, **sample})

    def note_xla_cost(self, entry: str, cost: Dict[str, float], weight: float = 1.0,
                      kernels: Optional[Dict[str, list]] = None) -> None:
        """One metered batch of executions (``obs/cost.py``): ``weight``
        executions of ``cost`` (the library operations of one execution)
        and the kernels' work they launched (``{kernel: [launches, flops,
        bytes]}``).  Distinct programs under one entry (host and device
        paths in one fit, a degraded re-run) keep one row each, by their
        per-execution cost, suffixed ``#2``, ``#3`` (the JAX package's
        rule)."""
        key = entry
        suffix = 2
        while True:
            row = self.xla_costs.get(key)
            if row is None or (row["flops_per_execution"] == cost["flops"]
                               and row["bytes_per_execution"] == cost["bytes"]):
                break
            key = f"{entry}#{suffix}"
            suffix += 1
        row = self.xla_costs.setdefault(key, {
            "flops_per_execution": cost["flops"],
            "bytes_per_execution": cost["bytes"],
            "executions": 0.0,
            "kernels": {},
        })
        if cost.get("peak_bytes"):
            row["peak_bytes_per_execution"] = cost["peak_bytes"]
        row["executions"] += weight
        for name, (launches, flops, nbytes) in (kernels or {}).items():
            k = row["kernels"].setdefault(name, {"launches": 0.0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += launches
            k["flops"] += flops
            k["bytes"] += nbytes

    def finish(self) -> None:
        if self._finished:
            return  # a failure-path bundle may have finished us already
        self._finished = True
        self.add_memory_sample("end")
        snap = telemetry.snapshot()
        self.kernels = kernel_counts(snap["counters"], self._base)
        by_entry = {}
        for key, now in snap["per_entry"].items():
            if not key.startswith(_KERNEL_PREFIXES):
                continue
            base = self._base_entry.get(key, {})
            delta = {e: n - base.get(e, 0.0) for e, n in now.items() if n - base.get(e, 0.0) > 0}
            if delta:
                by_entry[key] = delta
        self.kernels["by_entry"] = by_entry

    @property
    def peak_memory(self) -> Dict[str, float]:
        peaks: Dict[str, float] = {}
        for sample in self.memory_samples:
            for key, value in sample.items():
                if key != "phase":
                    peaks[key] = max(peaks.get(key, 0.0), value)
        return peaks


@contextlib.contextmanager
def fit_capture(name: str):
    """Activate phase-boundary memory sampling and kernel-count deltas for
    one fit; yields the :class:`FitCapture` (None when tracing is off)."""
    if not _trace.tracing_enabled():
        yield None
        return
    cap = FitCapture(name)
    token = _active_capture.set(cap)
    cap.add_memory_sample("start")
    try:
        yield cap
    finally:
        _active_capture.reset(token)
        cap.finish()


def sample_capture_memory(tag: str) -> None:
    """A memory sample into the active fit capture, if any (the cost
    meter takes one before it resets the card's peak reads)."""
    cap = _active_capture.get()
    if cap is not None:
        cap.add_memory_sample(tag)


def note_xla_cost(entry: str, cost: Dict[str, float], weight: float = 1.0,
                  kernels: Optional[Dict[str, list]] = None) -> None:
    """Relay one metered batch of executions into the active fit capture
    (the journal's per-entry table); dropped outside a capture -- the
    process-wide totals live in the telemetry counters regardless."""
    cap = _active_capture.get()
    if cap is not None:
        cap.note_xla_cost(entry, cost, weight, kernels)


def on_phase_boundary(instr_name: str, phase_name: str) -> None:
    """Called by ``Instrumentation.phase`` on every phase exit: samples
    memory into the active capture; a contextvar read otherwise."""
    cap = _active_capture.get()
    if cap is not None:
        cap.add_memory_sample(phase_name)


# -- run journal -------------------------------------------------------------

JOURNAL_FORMAT = "spark_gp_tpu_torch.run_journal/v1"

#: bumped when journal keys change meaning (the JAX package's is at 2;
#: the port's journal starts at its schema)
JOURNAL_SCHEMA_VERSION = 2

#: keys every schema-valid journal carries: the JAX package's, with the
#: kernel builds and launches (``kernels``) in place of its compile counts
JOURNAL_REQUIRED_KEYS = (
    "format", "name", "created_unix", "pid", "build_info", "precision_lane",
    "timings", "metrics", "degradations", "quarantine", "kernels",
    "memory", "spans",
)


def validate_journal(journal: dict) -> List[str]:
    """Schema check: the list of problems (empty = valid)."""
    problems = []
    if journal.get("format") != JOURNAL_FORMAT:
        problems.append(f"format is {journal.get('format')!r}")
    for key in JOURNAL_REQUIRED_KEYS:
        if key not in journal:
            problems.append(f"missing required key {key!r}")
    for key in ("timings", "metrics", "quarantine", "memory", "kernels"):
        if key in journal and not isinstance(journal[key], dict):
            problems.append(f"{key} is not an object")
    for key in ("spans", "degradations"):
        if key in journal and not isinstance(journal[key], list):
            problems.append(f"{key} is not a list")
    return problems


def _xla_cost_summary(capture: Optional[FitCapture], timings: Dict[str, float],
                      lane: str) -> Optional[dict]:
    """The journal's metered-cost block: the per-entry tables of the
    capture (``flops_total`` / ``bytes_total``: the library operations'
    per-execution cost times the executions, plus the kernels' work) and
    the optimize phase's MFU against the card's peak for ``lane``
    (``obs/cost.mfu_against_peak``, None on the CPU).  None when metering
    was off for the fit."""
    if capture is None or not capture.xla_costs:
        return None
    from spark_gp_tpu_torch.obs import cost as obs_cost

    entries = {}
    flops_total = 0.0
    for entry, row in capture.xla_costs.items():
        kernels = {k: dict(v) for k, v in row["kernels"].items()}
        total = row["flops_per_execution"] * row["executions"] + sum(
            k["flops"] for k in kernels.values())
        nbytes = row["bytes_per_execution"] * row["executions"] + sum(
            k["bytes"] for k in kernels.values())
        entries[entry] = {**row, "kernels": kernels, "flops_total": total, "bytes_total": nbytes}
        flops_total += total
    opt_s = timings.get("optimize_hypers")
    return {
        "entries": entries,
        "flops_total": flops_total,
        "optimize_seconds": opt_s,
        "measured_mfu_optimize": obs_cost.mfu_against_peak(flops_total, opt_s or 0.0, lane),
    }


def _memory_plan_rows(instr, capture: Optional[FitCapture]) -> List[dict]:
    """The journal's ``memory_plan`` block: every plan decision stamped on
    the fit, annotated with the fit's measured device peak and, when cost
    metering ran, the largest metered per-execution peak
    (``compiled_peak_bytes``, ``obs/cost.py``).  The breach compares like
    for like: the metered per-execution peak where there is one (the
    prediction's own granularity; a device fit's is its initial
    evaluation's, the one execution of the loop that runs outside the
    captured graph, ``obs/cost.ReplayMeter.initial``), else the whole
    fit's device peak; a peak above a fitting row's margined prediction
    counts ``plan.margin_breach``."""
    rows = [dict(r) for r in (getattr(instr, "memory_plan", []) or [])]
    actual = compiled = None
    if capture is not None:
        actual = capture.peak_memory.get("memory.peak_bytes_in_use")
        peaks = [row.get("peak_bytes_per_execution") for row in capture.xla_costs.values()
                 if row.get("peak_bytes_per_execution")]
        compiled = max(peaks) if peaks else None
    for row in rows:
        row["actual_peak_bytes"] = actual
        row["compiled_peak_bytes"] = compiled
        predicted = row.get("predicted_bytes")
        measured = compiled if compiled is not None else actual
        breach = bool(predicted and row.get("fits") and measured is not None
                      and measured > predicted)
        row["margin_breach"] = breach
        if breach:
            telemetry.inc("plan.margin_breach", entry=row.get("entry"))
    return rows


def write_run_journal(instr, root, capture: Optional[FitCapture],
                      trace_token: Optional[str] = None) -> dict:
    """Assemble (and persist into ``GP_RUN_JOURNAL_DIR`` when set) one
    fit's run journal, as
    ``run_journal_<name>-<unix_ms>-p<pid>-t<trace_id>.json``.  ``root`` is
    the fit's closed root span; ``spans`` is its reassembled tree."""
    from spark_gp_tpu_torch.ops.iterative import active_solver_lane
    from spark_gp_tpu_torch.ops.precision import active_lane

    spans = _trace.spans_of_root(root) if getattr(root, "trace_id", 0) else []
    metrics = getattr(instr, "metrics", {})
    quarantine_events = [
        {**event, "span": s.name}
        for s in spans
        for event in s.events
        if event["name"].startswith(("experts.", "fit.retry", "fallback."))
    ]
    journal = {
        "format": JOURNAL_FORMAT,
        "schema_version": JOURNAL_SCHEMA_VERSION,
        "name": getattr(instr, "name", "gp"),
        "created_unix": time.time(),
        "trace_id": trace_token if trace_token is not None else active_trace_token(),
        "pid": os.getpid(),
        "build_info": build_info(),
        "precision_lane": metrics.get("precision_lane", active_lane()),
        "solver_lane": metrics.get("solver_lane", active_solver_lane()),
        "mesh": None,
        "timings": dict(getattr(instr, "timings", {})),
        "metrics": dict(metrics),
        "degradations": list(getattr(instr, "degradations", [])),
        "memory_plan": _memory_plan_rows(instr, capture),
        # the fit-time per-expert quality probe (models/common.
        # _emit_expert_quality); None when it was skipped or disabled
        "expert_quality": getattr(instr, "expert_quality", None),
        "quarantine": {
            "experts_quarantined": metrics.get("experts_quarantined", 0.0),
            "experts_jittered": metrics.get("experts_jittered", 0.0),
            "fit_retries": metrics.get("fit_retries", 0.0),
            "events": quarantine_events,
        },
        "kernels": (
            dict(capture.kernels) if capture is not None
            else {"builds": {}, "launches": {}, "by_entry": {}}
        ),
        "memory": (
            {"samples": list(capture.memory_samples), "peak": capture.peak_memory}
            if capture is not None else {"samples": [], "peak": {}}
        ),
        "span_count": len(spans),
        "spans": _trace.span_tree(spans),
        # metered flops and bytes and the optimize phase's MFU
        # (obs/cost.py); None when GP_XLA_COST was off for the fit
        "xla_cost": _xla_cost_summary(
            capture, dict(getattr(instr, "timings", {})),
            metrics.get("precision_lane", active_lane())),
        "path": None,
    }
    journal_dir = os.environ.get("GP_RUN_JOURNAL_DIR", "").strip() or None
    if journal_dir is not None:
        try:
            os.makedirs(journal_dir, exist_ok=True)
            tag = (f"{int(journal['created_unix'] * 1000):d}"
                   f"-p{os.getpid()}-t{getattr(root, 'trace_id', 0)}")
            path = os.path.join(journal_dir, f"run_journal_{journal['name']}-{tag}.json")
            write_json_atomic(path, journal)
            journal["path"] = path
        except OSError as exc:
            # the journal is telemetry, never a fit failure -- but say so
            logger.warning("run journal not persisted to %r: %s", journal_dir, exc)
    return journal
