"""Structured fit instrumentation (the port's copy of the JAX package's
``utils/instrumentation.py``).

Named, timed phases with a metrics dict and standard :mod:`logging`
output.  Every phase is also a span of the unified tracer
(:mod:`spark_gp_tpu_torch.obs.trace`), samples the memory gauges at its
boundary (:mod:`spark_gp_tpu_torch.obs.runtime`) and, when it raises,
leaves a ``<phase>.failed`` marker in the metrics.  A phase's clock is
the host's: each of the fit's phases ends in a device-to-host read (the
optimizer's per-evaluation fetch, the statistics' fetch), so it covers
the device work; ``GP_SYNC_PHASES=1`` adds a ``torch.cuda.synchronize``
at each phase's end for timings that cannot depend on that.

:func:`maybe_profile` captures a ``torch.profiler`` trace (CPU and CUDA
activities) of the fit into a directory as a Chrome trace
(``setProfileDir`` or ``GP_TRACE_DIR``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from spark_gp_tpu_torch.obs import runtime as _obs_runtime
from spark_gp_tpu_torch.obs import trace as _obs_trace

logger = logging.getLogger("spark_gp_tpu_torch")


@dataclass
class Instrumentation:
    """Per-phase wall-clock timings and scalar metrics of one fit, with
    what the fit records beside its result: the aggregation weights of
    fit-time selection (a quarantine zeroes them), the ladder's
    ``degradations``, the memory plan's rows, the recovery's per-expert
    jitter, the expert-quality table and the covariate summary."""

    name: str = "gp"
    timings: Dict[str, float] = field(default_factory=dict)
    metrics: Dict[str, float] = field(default_factory=dict)
    agg_weights: Optional[np.ndarray] = None
    degradations: List[dict] = field(default_factory=list)
    memory_plan: List[dict] = field(default_factory=list)
    #: the per-expert jitter the recovery ladder settled on (None: none)
    expert_jitter: Optional[np.ndarray] = None
    #: the fit-time per-expert quality probe's table (run journal)
    expert_quality: Optional[dict] = None
    #: the training covariates' summary (``obs/quality.summarize_covariates``)
    covariate_summary: Optional[dict] = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def log_warning(self, msg: str) -> None:
        logger.warning("[%s] %s", self.name, msg)

    @contextlib.contextmanager
    def phase(self, phase_name: str):
        start = time.perf_counter()
        try:
            with _obs_trace.span(phase_name, instr=self.name):
                yield
                phase_sync()
        except BaseException:  # failure-marker metric only — re-raised
            with self._lock:
                self.metrics[f"{phase_name}.failed"] = 1.0
            raise
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.timings[phase_name] = self.timings.get(phase_name, 0.0) + elapsed
            logger.info("[%s] phase %s: %.3fs", self.name, phase_name, elapsed)
            _obs_runtime.on_phase_boundary(self.name, phase_name)

    def log_metric(self, key: str, value) -> None:
        with self._lock:
            self.metrics[key] = value
        logger.info("[%s] %s = %s", self.name, key, value)


def sync_enabled() -> bool:
    """The ``GP_SYNC_PHASES`` gate, read at call time."""
    return os.environ.get("GP_SYNC_PHASES", "").strip() not in ("", "0")


def phase_sync() -> None:
    """``torch.cuda.synchronize()`` under ``GP_SYNC_PHASES=1`` in a process
    that holds a CUDA context; a no-op otherwise (the default: the fit's
    own host reads already bound each phase)."""
    if not sync_enabled():
        return
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], name: str = "fit"):
    """A ``torch.profiler`` capture (CPU and, with a card, CUDA
    activities) of the block, exported as a Chrome trace
    ``<trace_dir>/trace_<name>-<unix_ms>-p<pid>.json`` (readable by
    ``chrome://tracing`` and Perfetto); a no-op without a directory.  With
    no explicit directory ``GP_TRACE_DIR`` (read at call time) names
    one."""
    if trace_dir is None:
        trace_dir = os.environ.get("GP_TRACE_DIR", "").strip() or None
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_{name}-{int(time.time() * 1000):d}-p{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("[%s] profiler trace written to %s", name, path)
