"""Context-var span tracer: one tree per fit (the port's copy of the JAX
package's ``obs/trace.py``).

A span is a named, timed, attributed interval; spans nest through a
:mod:`contextvars` context variable (thread- and task-local); finished
spans land in a process-global ring buffer, and each trace's root keeps
its own finished spans, so a fit's tree survives ring eviction.

Cost discipline: only coarse units open spans -- a fit's root and its
phases (``utils/instrumentation.py``) -- never an objective evaluation,
and opening one reads no device state.  Span creation is one object and
one contextvar set/reset.  ``GP_TRACING=0`` (or :func:`set_tracing`)
turns the whole layer into no-ops.

Exports: :func:`export_jsonl` (one span per line) and
:func:`chrome_trace` -- the Chrome/Perfetto ``trace_event`` JSON that
``chrome://tracing`` and https://ui.perfetto.dev render as a timeline.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# the flight recorder is the span events' second sink (obs/recorder.py);
# it has no top-level obs imports, so this cannot cycle
from spark_gp_tpu_torch.obs.recorder import RECORDER as _RECORDER

_ids = itertools.count(1)  # CPython-atomic; no lock needed

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "gp_obs_current_span", default=None
)

_forced: Optional[bool] = None


def tracing_enabled() -> bool:
    """ONE definition of the tracer gate, read at call time (like
    ``GP_SYNC_PHASES``): ``set_tracing`` wins, else ``GP_TRACING`` (any
    value but ``0``/``off``/``false`` — default on)."""
    if _forced is not None:
        return _forced
    return os.environ.get("GP_TRACING", "").strip().lower() not in (
        "0", "off", "false",
    )


def set_tracing(enabled: Optional[bool]) -> None:
    """Force the tracer on/off for this process (None = back to the env)."""
    global _forced
    _forced = enabled


class Span:
    """One finished-or-running interval of a trace tree.

    A slotted plain class, not a dataclass: span creation is the
    tracer's whole per-phase cost."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "root", "start_unix",
        "start", "thread", "attrs", "events", "duration_s", "status",
        # the trace's root Span object; finished spans register themselves
        # on root.trace_spans, so reassembling ONE trace (the run journal)
        # is O(trace) instead of an O(ring) scan
        "root_span", "trace_spans",
    )

    def __init__(
        self, name, trace_id, span_id, parent_id, root, start_unix, start,
        thread, attrs=None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.root = root
        self.start_unix = start_unix
        self.start = start
        self.thread = thread
        self.attrs: Dict[str, Any] = attrs if attrs is not None else {}
        self.events: List[dict] = []
        self.duration_s: Optional[float] = None
        self.status = "ok"
        self.root_span: Optional["Span"] = None
        self.trace_spans: Optional[List["Span"]] = None

    def add_event(self, name: str, **attrs) -> None:
        self.events.append(
            {"name": name, "t_unix": time.time(), **attrs}
        )

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.start_unix,
            "duration_s": self.duration_s,
            "thread": self.thread,
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class _NoopSpan:
    """What :func:`span` yields when tracing is off: absorbs the span API
    at zero cost, never enters the ring."""

    name = ""
    trace_id = 0
    span_id = 0
    parent_id = None
    root = ""
    events: List[dict] = []
    attrs: Dict[str, Any] = {}

    def add_event(self, name: str, **attrs) -> None:
        pass

    def set_attr(self, key: str, value) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class SpanRing:
    """Thread-safe bounded buffer of finished spans (oldest evicted)."""

    def __init__(self, capacity: int = 4096):
        self._buf: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self.dropped = 0  # spans evicted by the bound (monotonic)

    def append(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    def snapshot(self, trace_id: Optional[int] = None) -> List[Span]:
        with self._lock:
            spans = list(self._buf)
        if trace_id is None:
            return spans
        return [s for s in spans if s.trace_id == trace_id]


#: the process-global buffer every finished span lands in
RING = SpanRing(4096)


class span:
    """Open a span: child of the context's current span, or a new trace
    root.  ``with span(name, **attrs) as s:`` yields the :class:`Span`
    (a no-op stub when tracing is off); an escaping exception marks
    ``status="error"`` and re-raises.

    A hand-rolled context manager (not ``@contextmanager``): the
    generator protocol costs several microseconds per use."""

    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, **attrs):
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> "Span":
        if not tracing_enabled():
            return NOOP_SPAN
        parent = _current.get()
        if parent is not None:
            s = Span(
                self._name, parent.trace_id, next(_ids), parent.span_id,
                parent.root, time.time(), time.perf_counter(),
                threading.current_thread().name, self._attrs,
            )
            s.root_span = parent.root_span
        else:
            s = Span(
                self._name, next(_ids), next(_ids), None, self._name,
                time.time(), time.perf_counter(),
                threading.current_thread().name, self._attrs,
            )
            s.root_span = s
            s.trace_spans = []
        self._span = s
        self._token = _current.set(s)
        return s

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        if s is None:  # tracing was off at __enter__
            return False
        if exc_type is not None:
            s.status = "error"
            s.add_event("error", type=exc_type.__name__)
            # erroring spans feed the flight recorder: failure-path-only
            # cost, and the incident bundle's event log then shows WHICH
            # unit of work broke even after the span ring evicts
            _RECORDER.record("error", span=s.name, type=exc_type.__name__)
        s.duration_s = time.perf_counter() - s.start
        _current.reset(self._token)
        root_list = s.root_span.trace_spans
        if root_list is not None:
            root_list.append(s)
        RING.append(s)
        return False


def current_span() -> Optional[Span]:
    """The context's active span, or None (tracing off / no span open)."""
    return _current.get()


def add_event(name: str, **attrs) -> bool:
    """Attach a timestamped event to the current span; False (dropped
    from the SPAN) when no span is open — event emitters never need
    their own guard.  Every event is additionally relayed into the
    flight recorder (:mod:`spark_gp_tpu_torch.obs.recorder`) whether or not a
    span is open: the recorder is the incident bundle's event log."""
    _RECORDER.record(name, **attrs)
    s = _current.get()
    if s is None:
        return False
    s.add_event(name, **attrs)
    return True


def current_root_name() -> Optional[str]:
    """Root-span name of the active trace (the kernel-launch attribution
    entry point), or None outside any span."""
    s = _current.get()
    return s.root if s is not None else None


# -- reassembly + export ----------------------------------------------------


def spans_for_trace(trace_id: int) -> List[Span]:
    """Every retained span of one trace, in start order (ring scan — for
    ad-hoc queries; a caller holding the ROOT span should use
    :func:`spans_of_root`, which is O(trace))."""
    return sorted(RING.snapshot(trace_id), key=lambda s: s.start)


def spans_of_root(root: Span) -> List[Span]:
    """The finished spans of ``root``'s trace, in start order — collected
    on the root itself, immune to ring eviction and ring size."""
    if getattr(root, "trace_spans", None) is None:
        return []
    return sorted(root.trace_spans, key=lambda s: s.start)


def span_tree(spans: List[Span]) -> List[dict]:
    """Nest a flat span list into ``[{..., "children": [...]}]`` roots.

    A span whose parent was evicted from the ring becomes a root — the
    tree degrades, it never drops spans silently."""
    nodes = {s.span_id: {**s.to_dict(), "children": []} for s in spans}
    roots = []
    for s in sorted(spans, key=lambda s: s.start):
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id) if s.parent_id is not None else None
        (parent["children"] if parent is not None else roots).append(node)
    return roots


def export_jsonl(path: str, spans: Optional[List[Span]] = None) -> int:
    """Write spans (default: the whole ring) as JSON lines; returns the
    span count.  Attr values that aren't JSON types degrade to ``str``."""
    spans = RING.snapshot() if spans is None else spans
    with open(path, "w", encoding="utf-8") as fh:
        for s in spans:
            fh.write(json.dumps(s.to_dict(), default=str) + "\n")
    return len(spans)


def chrome_trace(spans: Optional[List[Span]] = None) -> dict:
    """Chrome/Perfetto ``trace_event`` document: spans as complete
    (``"ph": "X"``) events, span events as instants (``"ph": "i"``),
    plus ``process_name``/``thread_name`` metadata (``"ph": "M"``) so
    Perfetto renders named lanes instead of bare tids."""
    spans = RING.snapshot() if spans is None else spans
    pid = os.getpid()
    tids = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        events.append({
            "name": s.name,
            "cat": s.root,
            "ph": "X",
            "ts": s.start_unix * 1e6,
            "dur": (s.duration_s or 0.0) * 1e6,
            "pid": pid,
            "tid": tid,
            "args": {k: str(v) for k, v in s.attrs.items()},
        })
        for e in s.events:
            events.append({
                "name": e["name"],
                "cat": s.root,
                "ph": "i",
                "s": "t",
                "ts": e["t_unix"] * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {
                    k: str(v) for k, v in e.items()
                    if k not in ("name", "t_unix")
                },
            })
    # metadata events FIRST (the trace_event spec allows any position,
    # but naming the lanes up front renders correctly in every viewer):
    # one process_name carrying the pid, one thread_name per lane
    meta = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": f"spark_gp_tpu_torch p{pid}"},
    }]
    for thread_name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": thread_name},
        })
    return {
        "traceEvents": meta + events,
        "metadata": {
            "threads": {str(v): k for k, v in tids.items()},
            "spans_dropped": RING.dropped,
        },
    }


def export_chrome_trace(path: str, spans: Optional[List[Span]] = None) -> int:
    """``chrome_trace`` straight to a file; returns the event count."""
    doc = chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])
