"""Flight recorder + incident bundles: the fit's forensics plane (the
port's copy of the JAX package's ``obs/recorder.py``).

* a **flight recorder** -- a bounded ring of structured events, fed by
  every span event (:func:`spark_gp_tpu_torch.obs.trace.add_event` relays
  here even when no span is open), erroring spans and classified-failure
  observations (``resilience/fallback.record_failure``).
  ``GP_RECORDER=0`` (or :func:`set_recording`) turns the feed into a
  no-op;
* **incident bundles** -- on a *terminal* classified failure (a fit
  raising out of ``models/common._observed_fit``, a predict ladder
  raising its classified error) ONE JSON artifact (tmp + atomic rename)
  is written into ``GP_INCIDENT_DIR`` or else ``GP_RUN_JOURNAL_DIR``:
  the failing span tree, the last recorder events, the degradation-rung
  history, the kernel builds and launches and the memory samples of the
  fit, build provenance and the staged chaos environment.

A fit that completed through a fallback rung does NOT bundle (its run
journal carries the ``degradations``), and ``unknown`` failures never
bundle -- among them every ``KernelBuildError`` and ``KernelLaunchError``
(``ops/cuda_lib.py``), which the ladder never degrades.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger("spark_gp_tpu_torch")

#: schema version of the incident-bundle JSON
BUNDLE_FORMAT = "spark_gp_tpu_torch.incident_bundle/v1"

#: keys every schema-valid bundle carries: the JAX package's, with the
#: kernel builds and launches (``kernels``) in place of its compile counts
BUNDLE_REQUIRED_KEYS = (
    "format", "reason", "created_unix", "pid", "trace_id", "failure_class",
    "error", "degradations", "spans", "events", "kernels", "memory",
    "build_info", "chaos", "recorder",
)

_seq = itertools.count(1)  # CPython-atomic, like trace._ids

_forced: Optional[bool] = None


def recording_enabled() -> bool:
    """The recorder gate, read at call time: ``set_recording`` wins, else
    ``GP_RECORDER`` (default on)."""
    if _forced is not None:
        return _forced
    return os.environ.get("GP_RECORDER", "").strip().lower() not in ("0", "off", "false")


def set_recording(enabled: Optional[bool]) -> None:
    """Force the recorder on/off for this process (None = back to env)."""
    global _forced
    _forced = enabled


class FlightRecorder:
    """Thread-safe bounded ring of structured events (oldest evicted):
    monotonic ``seq``, wall-clock ``t_unix``, emitting ``thread``,
    ``name`` and the emitter's attributes."""

    def __init__(self, capacity: int = 2048):
        self._buf: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self.dropped = 0  # events evicted by the bound (monotonic)

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def record(self, name: str, **attrs) -> None:
        if not recording_enabled():
            return
        event = {
            "seq": next(_seq),
            "t_unix": time.time(),
            "thread": threading.current_thread().name,
            "name": name,
            **attrs,
        }
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(event)

    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            events = list(self._buf)
        if last is not None and last >= 0:
            events = events[-last:]
        return events


#: the process-global recorder every feed lands in
RECORDER = FlightRecorder(2048)

#: events included in a bundle (the ring may be larger)
BUNDLE_LAST_EVENTS = 256

_INCIDENT_MARK = "_gp_incident_path"


def write_json_atomic(path: str, doc: dict) -> None:
    """``doc`` as JSON at ``path``: written to ``path.tmp``, flushed to
    disk, then renamed over ``path``, so a reader never sees half a file."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=str)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def incident_dir() -> Optional[str]:
    """Where bundles land: ``GP_INCIDENT_DIR``, else ``GP_RUN_JOURNAL_DIR``;
    None disables persistence (the bundle is still assembled and counted)."""
    for name in ("GP_INCIDENT_DIR", "GP_RUN_JOURNAL_DIR"):
        candidate = os.environ.get(name, "").strip()
        if candidate:
            return candidate
    return None


def _chaos_environment() -> Dict[str, str]:
    """The staged chaos knobs at failure time: the repro recipe."""
    return {
        key: value
        for key, value in sorted(os.environ.items())
        if key.startswith("GP_CHAOS_") or key == "GP_SEED"
    }


def _span_tree_of(root) -> List[dict]:
    """The failing trace's span tree from the ROOT span's own finished
    spans, with the root synthesized at the head while it is still open
    (we are inside its except clause)."""
    from spark_gp_tpu_torch.obs import trace as obs_trace

    if root is None or not getattr(root, "trace_id", 0):
        return []
    tree = obs_trace.span_tree(obs_trace.spans_of_root(root))
    if not tree or tree[0].get("name") != getattr(root, "name", None):
        tree = [{**root.to_dict(), "children": tree}]
    return tree


def already_bundled(exc: Optional[BaseException]) -> Optional[str]:
    """Bundle path a propagating exception was already dumped for, or
    None: the debounce that keeps nested trigger points (a predict ladder
    inside a fit) from double-dumping one incident."""
    return getattr(exc, _INCIDENT_MARK, None) if exc is not None else None


def dump_incident(
    reason: str,
    exc: Optional[BaseException] = None,
    failure_class: Optional[str] = None,
    root=None,
    instr=None,
    capture=None,
    trace_id: Optional[str] = None,
    extra: Optional[dict] = None,
) -> Optional[dict]:
    """Assemble (and persist, when a directory resolves) ONE incident
    bundle; returns the bundle dict, or None when debounced.  Never
    raises: forensics must not replace the failure it documents -- any
    failure here is logged and counted as ``incident.bundle_failures``."""
    try:
        return _dump_incident_inner(reason, exc, failure_class, root, instr,
                                    capture, trace_id, extra)
    except Exception:  # noqa: BLE001 — see docstring: never raises
        logger.warning("incident bundle assembly failed for %r", reason, exc_info=True)
        from spark_gp_tpu_torch.obs.runtime import telemetry

        telemetry.inc("incident.bundle_failures")
        return None


def _dump_incident_inner(reason, exc, failure_class, root, instr, capture,
                         trace_id, extra) -> Optional[dict]:
    if already_bundled(exc) is not None:
        return None
    from spark_gp_tpu_torch.obs import runtime as obs_runtime
    from spark_gp_tpu_torch.obs import trace as obs_trace

    if capture is not None:
        capture.finish()  # idempotent: the bundle needs the deltas now
    if trace_id is None:
        trace_id = obs_runtime.active_trace_token()
    degradations = []
    for source in (exc, instr):
        got = list(getattr(source, "degradations", []) or [])
        if got:
            degradations = got
            break
    snap = obs_runtime.telemetry.snapshot()
    bundle = {
        "format": BUNDLE_FORMAT,
        "reason": reason,
        "created_unix": time.time(),
        "pid": os.getpid(),
        "trace_id": trace_id,
        "failure_class": failure_class,
        "error": None if exc is None else f"{type(exc).__name__}: {exc}"[:500],
        "degradations": degradations,
        "memory_plan": list(getattr(instr, "memory_plan", []) or []),
        "spans": _span_tree_of(root),
        "events": RECORDER.snapshot(last=BUNDLE_LAST_EVENTS),
        "kernels": (
            capture.kernels if capture is not None
            else obs_runtime.kernel_counts(snap["counters"])
        ),
        "memory": {
            "samples": list(capture.memory_samples) if capture is not None else [],
            "gauges": dict(snap["gauges"]),
        },
        "timings": dict(getattr(instr, "timings", {}) or {}),
        "metrics": {
            k: v for k, v in (getattr(instr, "metrics", {}) or {}).items()
            if isinstance(v, (int, float, str, bool))
        },
        "build_info": obs_runtime.build_info(),
        "chaos": _chaos_environment(),
        "recorder": {"dropped": RECORDER.dropped, "capacity": RECORDER.capacity},
        "path": None,
        **(extra or {}),
    }
    # one emission: add_event relays into THIS recorder too (trace.py)
    obs_trace.add_event("incident.bundle", reason=reason, failure_class=failure_class)
    target = incident_dir()
    if target is not None:
        try:
            os.makedirs(target, exist_ok=True)
            tag = f"{int(bundle['created_unix'] * 1000):d}-p{os.getpid()}"
            path = os.path.join(target, f"incident_{reason.replace('.', '_')}-{tag}.json")
            write_json_atomic(path, bundle)
            bundle["path"] = path
        except OSError:
            obs_runtime.telemetry.inc("incident.bundle_failures")
            logger.warning("incident bundle not persisted to %r", target, exc_info=True)
    obs_runtime.telemetry.inc("incident.bundles")
    if exc is not None:
        try:
            setattr(exc, _INCIDENT_MARK, bundle["path"] or "<unpersisted>")
        except (AttributeError, TypeError):
            pass  # slotted/frozen exception: worst case is a second bundle
    return bundle


def record_fit_failure(exc: BaseException, entry: str, instr=None, root=None,
                       capture=None) -> Optional[dict]:
    """The fit entry points' bundle trigger (``common._observed_fit``):
    dump for terminal CLASSIFIED failures and for
    ``DegradationExhaustedError``; anything the taxonomy cannot name
    (``unknown``) stays bundle-free."""
    from spark_gp_tpu_torch.resilience import fallback

    cls = fallback.classify_failure(exc)
    if cls == fallback.UNKNOWN and not isinstance(exc, fallback.DegradationExhaustedError):
        return None
    return dump_incident(reason=entry, exc=exc, failure_class=cls, root=root,
                         instr=instr, capture=capture)


def validate_bundle(bundle: dict) -> List[str]:
    """Schema check: the list of problems (empty = valid)."""
    problems = []
    if bundle.get("format") != BUNDLE_FORMAT:
        problems.append(f"format is {bundle.get('format')!r}")
    for key in BUNDLE_REQUIRED_KEYS:
        if key not in bundle:
            problems.append(f"missing required key {key!r}")
    for key in ("events", "spans", "degradations"):
        if not isinstance(bundle.get(key), list):
            problems.append(f"{key} is not a list")
    return problems
