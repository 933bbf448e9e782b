"""Serving metrics: counters, gauges and latency histograms (the port's copy
of the JAX package's ``serve/metrics.py``).

Extends :class:`spark_gp_tpu_torch.utils.instrumentation.Instrumentation`
(named phases and fit metrics) with what a request-driven workload needs:
monotonic counters (requests, batches, shed load, bucket builds),
point-in-time gauges (queue depth) and bounded latency histograms with
percentile snapshots (p50 / p99).  Every entry point is thread-safe: the
submit path, the batcher thread and a metrics reader touch one instance
at once.  Watchlisted increments also land in the flight recorder
(``obs/recorder.RECORDER.note_metric``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from spark_gp_tpu_torch.obs.recorder import RECORDER as _RECORDER
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation


class LatencyHistogram:
    """Bounded-memory sample reservoir with percentile snapshots.

    A ring buffer of the most recent ``capacity`` observations: recency is
    the right bias for serving dashboards (a warm-up spike should age out,
    not poison p99 forever), and the memory bound holds under sustained
    traffic.  ``count`` still reports every observation ever made.

    Alongside the window, fixed-``bounds`` bucket counters accumulate
    monotonically over the histogram's whole lifetime: Prometheus
    histogram ingestion (``rate()`` over ``_count``, ``histogram_quantile``
    over ``_bucket``) assumes cumulative-counter semantics, which a
    sliding window cannot provide — counts would freeze at ``capacity``
    and buckets could DECREASE, reading as counter resets.  The window
    feeds the p50/p99 snapshots; the bucket counters feed
    :mod:`spark_gp_tpu_torch.obs.expo`.
    """

    def __init__(self, capacity: int = 4096, bounds: tuple = ()):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._n = 0  # total observations (monotonic)
        self._lock = threading.Lock()
        self._bounds = np.asarray(sorted(bounds), dtype=np.float64)
        # per-interval counts; index len(bounds) is the +Inf overflow
        self._bucket_counts = np.zeros(self._bounds.shape[0] + 1, dtype=np.int64)
        self._sum = 0.0  # monotonic (latencies/sizes are non-negative)

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._buf[self._n % self._buf.shape[0]] = value
            self._n += 1
            # first bound >= value ("le" semantics); past-the-end -> +Inf
            self._bucket_counts[
                int(np.searchsorted(self._bounds, value, side="left"))
            ] += 1
            self._sum += value

    def window(self) -> np.ndarray:
        """Copy of the retained sample window (the raw observations the
        percentile snapshot is computed over)."""
        with self._lock:
            return self._buf[: min(self._n, self._buf.shape[0])].copy()

    def cumulative(self):
        """``(bounds, cumulative_counts, count, sum)`` with true monotonic
        counter semantics over the histogram's lifetime — the OpenMetrics
        ``_bucket``/``_count``/``_sum`` series (``obs/expo.py``).
        ``cumulative_counts[i]`` is observations ``<= bounds[i]``; the
        implicit +Inf bucket equals ``count``."""
        with self._lock:
            running = np.cumsum(self._bucket_counts)
            return (
                tuple(float(b) for b in self._bounds),
                [int(c) for c in running[:-1]],
                self._n,
                float(self._sum),
            )

    def snapshot(self) -> dict:
        """``{count, mean, p50, p99, max}`` over the retained window
        (zeros/None when nothing was observed yet)."""
        with self._lock:
            n = self._n
            window = self._buf[: min(n, self._buf.shape[0])].copy()
        if n == 0:
            return {"count": 0, "mean": None, "p50": None, "p99": None, "max": None}
        return {
            "count": n,
            "mean": float(window.mean()),
            "p50": float(np.percentile(window, 50)),
            "p99": float(np.percentile(window, 99)),
            "max": float(window.max()),
        }


class ServingMetrics(Instrumentation):
    """Thread-safe counters + gauges + histograms for the serve path.

    The inherited ``timings``/``metrics``/``phase`` keep working (the
    warmup stage reuses ``phase``, and a raising phase records its
    ``<phase>.failed`` marker); the additions below are the steady-state
    signals.  Histogram keys are created on first ``observe``.
    """

    def __init__(self, name: str = "serve", histogram_capacity: int = 4096):
        super().__init__(name=name)
        self._lock = threading.Lock()
        self._hist_capacity = histogram_capacity
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, LatencyHistogram] = {}

    def inc(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value
        # watchlisted increments (shed/breaker/watchdog/lifecycle keys)
        # feed the flight recorder OUTSIDE the lock — the incident
        # bundle's admission story; a one-prefix-check no-op for the
        # request/batch counters on the hot path
        _RECORDER.note_metric(key, value)

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = float(value)

    def observe(self, key: str, value: float) -> None:
        with self._lock:
            hist = self.histograms.get(key)
            if hist is None:
                from spark_gp_tpu_torch.obs.names import buckets_for

                hist = self.histograms[key] = LatencyHistogram(
                    self._hist_capacity, bounds=buckets_for(key)
                )
        hist.observe(value)

    def counter(self, key: str) -> float:
        with self._lock:
            return self.counters.get(key, 0.0)

    def histogram(self, key: str) -> Optional[LatencyHistogram]:
        with self._lock:
            return self.histograms.get(key)

    def snapshot(self) -> dict:
        """One JSON-ready dict: counters, gauges, per-histogram percentile
        summaries, plus the inherited phase timings/metrics."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.histograms)
            # inherited dicts share this instance's lock too (phase /
            # log_metric write under it from other threads)
            timings = dict(self.timings)
            metrics = dict(self.metrics)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.snapshot() for k, h in hists.items()},
            "timings": timings,
            "metrics": metrics,
        }
