"""OpenMetrics text exposition of the port's metric state (the port's
copy of the JAX package's ``obs/expo.py``).

Renders an :class:`~spark_gp_tpu_torch.utils.instrumentation.Instrumentation`
(phase timings + fit metrics) or a
:class:`~spark_gp_tpu_torch.serve.metrics.ServingMetrics` (counters,
gauges and latency histograms), plus the
:mod:`spark_gp_tpu_torch.obs.runtime` telemetry (kernel builds and
launches, memory gauges, ladder and plan counters), as one OpenMetrics
1.0 page; :class:`ScrapeListener` serves it on a localhost socket.

Mapping rules, the JAX package's:

* dotted keys become ``gp_``-prefixed underscore names
  (``fallback.transitions`` -> ``gp_fallback_transitions_total``); a
  trailing ``_s`` becomes ``_seconds`` with a ``# UNIT`` line;
* catalog patterns with a ``label`` collapse into ONE family with that
  label (``kernel.launches.spd_inv_logdet`` ->
  ``gp_kernel_launches_total{kernel="spd_inv_logdet"}``);
* a ``LatencyHistogram`` renders its lifetime-cumulative bucket counters
  (``_bucket`` / ``_count`` / ``_sum``, monotonic as Prometheus needs);
  its recency window feeds only the p50 / p99 JSON snapshots;
* fit metrics render as the single labeled family
  ``gp_fit_metric{key="..."}`` (strings as
  ``gp_fit_info{key=...,value=...} 1``).

The page ends with ``# EOF`` as the spec requires.
"""

from __future__ import annotations

import contextlib
import math
import socket
import threading
from typing import Dict, List, Optional, Tuple

from spark_gp_tpu_torch.obs import names as _names

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _fmt(value: float) -> str:
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return format(value, ".10g")


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _family_for(key: str) -> Tuple[str, Optional[str], Dict[str, str]]:
    """``(family_key, unit, labels)`` for one concrete emitted key: the
    catalog's labeled patterns collapse the dynamic part into a label,
    everything else maps 1:1."""
    spec = _names.lookup(key)
    labels: Dict[str, str] = {}
    family_key = key
    if spec is not None and "*" in spec.key and spec.label is not None:
        prefix = spec.key.split("*", 1)[0].rstrip(".")
        family_key = prefix if prefix else key
        if key.startswith(prefix) and len(key) > len(prefix):
            labels[spec.label] = key[len(prefix):].lstrip(".")
    unit = None
    if family_key.endswith("_s"):
        family_key = family_key[:-2] + "_seconds"
        unit = "seconds"
    return "gp_" + family_key.replace(".", "_"), unit, labels


def _help_for(key: str, fallback: str) -> str:
    spec = _names.lookup(key)
    return spec.help if spec is not None else fallback


class _Page:
    """Accumulates families, renders them sorted, one block per family."""

    def __init__(self):
        # family name -> (type, help, unit, [(suffix, labels, value)])
        self._families: Dict[str, list] = {}

    def add(self, family, mtype, help_text, unit, suffix, labels, value):
        entry = self._families.setdefault(family, [mtype, help_text, unit, []])
        entry[3].append((suffix, labels, value))

    def render(self) -> str:
        lines: List[str] = []
        for family in sorted(self._families):
            mtype, help_text, unit, samples = self._families[family]
            lines.append(f"# TYPE {family} {mtype}")
            if unit:
                lines.append(f"# UNIT {family} {unit}")
            if help_text:
                lines.append(f"# HELP {family} {help_text}")
            for suffix, labels, value in samples:
                lines.append(f"{family}{suffix}{_labels(labels)} {_fmt(value)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _add_histogram(page: _Page, key: str, hist) -> None:
    # the lifetime-cumulative counters, not the recency window
    family, unit, labels = _family_for(key)
    bounds, counts, count, total = hist.cumulative()
    help_text = _help_for(key, "latency histogram")
    for le, cum in zip(bounds, counts):
        page.add(family, "histogram", help_text, unit, "_bucket",
                 {**labels, "le": _fmt(le)}, cum)
    page.add(family, "histogram", help_text, unit, "_bucket",
             {**labels, "le": "+Inf"}, count)
    page.add(family, "histogram", help_text, unit, "_count", dict(labels), count)
    page.add(family, "histogram", help_text, unit, "_sum", dict(labels), total)


def render_openmetrics(metrics, runtime_snapshot: Optional[dict] = None) -> str:
    """One OpenMetrics page for an ``Instrumentation`` or a
    ``ServingMetrics`` (any object with ``counters`` / ``gauges`` /
    ``histograms`` / ``timings`` / ``metrics``), with the runtime telemetry
    snapshot merged in when given."""
    page = _Page()

    # build/runtime identity on every page (OpenMetrics info type: family
    # gp_build, sample gp_build_info{...} 1)
    from spark_gp_tpu_torch.obs.runtime import build_info

    page.add(
        "gp_build", "info",
        _help_for("build", "build/runtime identity"), None, "_info",
        {k: str(v) for k, v in build_info().items()}, 1.0,
    )

    # copy ALL instance state under its lock (the snapshot() discipline):
    # emitters insert first-time keys concurrently, and iterating the live
    # dicts would raise "dictionary changed size during iteration" mid-scrape
    instance_lock = getattr(metrics, "_lock", None)
    with instance_lock if instance_lock is not None else contextlib.nullcontext():
        counters = dict(getattr(metrics, "counters", {}) or {})
        gauges = dict(getattr(metrics, "gauges", {}) or {})
        histograms = dict(getattr(metrics, "histograms", {}) or {})
        timings = dict(getattr(metrics, "timings", {}) or {})
        fit_metrics = dict(getattr(metrics, "metrics", {}) or {})

    for key, value in sorted(counters.items()):
        family, unit, labels = _family_for(key)
        page.add(family, "counter", _help_for(key, "counter"), unit,
                 "_total", labels, value)
    for key, value in sorted(gauges.items()):
        family, unit, labels = _family_for(key)
        page.add(family, "gauge", _help_for(key, "gauge"), unit,
                 "", labels, value)
    for key, hist in sorted(histograms.items()):
        _add_histogram(page, key, hist)  # hist.cumulative() takes its own lock

    for key, value in sorted(timings.items()):
        page.add(
            "gp_phase_seconds", "counter",
            "accumulated wall-clock per instrumentation phase",
            "seconds", "_total", {"phase": key}, value,
        )
    for key, value in sorted(fit_metrics.items()):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            page.add(
                "gp_fit_metric", "gauge",
                "scalar fit diagnostics (see obs/names.py for keys)",
                None, "", {"key": key}, value,
            )
        else:
            page.add(
                "gp_fit_info", "gauge",
                "non-numeric fit diagnostics as key/value info",
                None, "", {"key": key, "value": str(value)}, 1.0,
            )

    if runtime_snapshot:
        for key, value in sorted(runtime_snapshot.get("counters", {}).items()):
            family, unit, labels = _family_for(key)
            page.add(family, "counter", _help_for(key, "runtime counter"),
                     unit, "_total", labels, value)
        for key, by_entry in sorted(
            runtime_snapshot.get("per_entry", {}).items()
        ):
            # a labeled pattern keeps its label beside the entry, so two
            # kernels' launches by one entry stay two series
            family, _, labels = _family_for(key)
            for entry, value in sorted(by_entry.items()):
                page.add(
                    family + "_by_entry", "counter",
                    _help_for(key, "runtime counter") + " (by entry point)",
                    None, "_total", {**labels, "entry": entry}, value,
                )
        for key, value in sorted(runtime_snapshot.get("gauges", {}).items()):
            family, unit, labels = _family_for(key)
            page.add(family, "gauge", _help_for(key, "runtime gauge"),
                     unit, "", labels, value)

    return page.render()


class ScrapeListener:
    """A plain-text scrape endpoint for the page on ``host:port`` (0 picks
    a free port, read back from :attr:`port`): any request gets an
    HTTP/1.0 200 with the freshly rendered page, enough for ``curl`` and
    a Prometheus target.  Bound to localhost by default: a metrics page
    tells much about the process."""

    def __init__(self, render, port: int = 0, host: str = "127.0.0.1"):
        self._render = render  # zero-argument callable -> page text
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="gp-metrics-scrape", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    conn.settimeout(2.0)
                    conn.recv(4096)  # the request itself is ignored
                    try:
                        body, status = self._render(), "200 OK"
                    except Exception as exc:  # noqa: BLE001 -- the listener survives
                        body = f"# render failed: {type(exc).__name__}\n"
                        status = "500 Internal Server Error"
                    payload = body.encode("utf-8")
                    head = (f"HTTP/1.0 {status}\r\nContent-Type: {CONTENT_TYPE}\r\n"
                            f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n")
                    conn.sendall(head.encode("ascii") + payload)
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
