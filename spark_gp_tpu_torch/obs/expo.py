"""OpenMetrics text exposition of a fit's metric state (the port's copy
of the JAX package's ``obs/expo.py``, fit half).

Renders an :class:`~spark_gp_tpu_torch.utils.instrumentation.Instrumentation`
(phase timings + fit metrics), plus the :mod:`spark_gp_tpu_torch.obs.runtime`
telemetry (kernel builds and launches, memory gauges, ladder and plan
counters), as one OpenMetrics 1.0 page.  The serving metrics' half (their
latency histograms and the scrape listener) waits for the port's serve
layer.

Mapping rules, the JAX package's:

* dotted keys become ``gp_``-prefixed underscore names
  (``fallback.transitions`` -> ``gp_fallback_transitions_total``); a
  trailing ``_s`` becomes ``_seconds`` with a ``# UNIT`` line;
* catalog patterns with a ``label`` collapse into ONE family with that
  label (``kernel.launches.spd_inv_logdet`` ->
  ``gp_kernel_launches_total{kernel="spd_inv_logdet"}``);
* fit metrics render as the single labeled family
  ``gp_fit_metric{key="..."}`` (strings as
  ``gp_fit_info{key=...,value=...} 1``).

The page ends with ``# EOF`` as the spec requires.
"""

from __future__ import annotations

import contextlib
import math
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


def render_openmetrics(metrics, runtime_snapshot: Optional[dict] = None) -> str:
    """One OpenMetrics page for an ``Instrumentation`` (or any object with
    ``counters`` / ``gauges`` / ``timings`` / ``metrics`` dicts), with the
    runtime telemetry snapshot merged in when given."""
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
