"""Shape-bucketed predict: one CUDA graph per (model, bucket), captured at
warmup (the port's counterpart of the JAX package's ``serve/batcher.py``,
whose XLA compiles one executable per bucket).

The eager predict launches one kernel per operation, and the host's
launch overhead dominates a small request.  The serving path therefore
quantizes request sizes to a small fixed ladder of power-of-two buckets,
pads each request up to its bucket and slices the answer back, and
captures the predict body of each bucket once as a ``torch.cuda.CUDAGraph``
over static buffers:

* theta, the active set, the magic vector and matrix are uploaded once;
* per bucket, a static ``[bucket, p]`` input buffer, and static mean and
  variance outputs written by the graph; the body is the predictor's own
  ``_predict_block`` (the cross kernel and its contractions in float64,
  the answers in the working dtype), warmed up eagerly on a side stream, then
  captured with ``capture_error_mode="thread_local"`` (a fit or another
  model may run on another thread meanwhile);
* the graphs of one predictor share one memory pool; :meth:`release`
  frees the graphs and the pool;
* a dispatch pads with the first active point, copies into the static
  buffer, replays and copies out, all under the predictor's dispatch lock,
  so that two threads (a replaced batcher worker beside a wedged one)
  never replay one graph at once.

A failed capture or replay raises :class:`GraphCaptureError` /
:class:`GraphReplayError`; the predictor never falls back to eager.  On
the CPU there is no graph: a bucket's first eager run counts as its
build, so ``compile_counts`` ("one build per bucket, none after warmup")
and :class:`RecompileGuardError` hold on both devices.

Requests are cast to the working dtype on entry (float32 on the card,
float64 on the CPU): one dtype per predictor.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import cuda_lib
from spark_gp_tpu_torch.utils.device import resolve_device, working_dtype


class BucketOverflowError(ValueError):
    """A request exceeded the largest bucket and chunking was disabled."""


class RecompileGuardError(RuntimeError):
    """A bucket build was asked for on the hot path after warmup declared
    the set of buckets complete."""


class GraphCaptureError(RuntimeError):
    """A bucket's CUDA graph failed to capture (a host sync or a
    data-dependent allocation in the predict body)."""


class GraphReplayError(RuntimeError):
    """A captured bucket graph failed to replay."""


def bucket_sizes(max_batch: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two bucket ladder ``(min_bucket, ..., max_batch)``, both
    ends rounded up to powers of two: one graph per rung, so 8..1024 is 8
    captures, not 1024."""
    if max_batch < 1 or min_bucket < 1:
        raise ValueError("max_batch and min_bucket must be >= 1")

    def _pow2(n: int) -> int:
        return 1 << (n - 1).bit_length()

    lo, hi = _pow2(min_bucket), _pow2(max_batch)
    if lo > hi:
        raise ValueError(f"min_bucket {min_bucket} exceeds max_batch {max_batch}")
    sizes, b = [], lo
    while b <= hi:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


class _BucketGraph:
    """One bucket's captured graph, its static buffers and its cost meter
    (``obs/cost.py``: one execution's cost counted at capture, one
    execution a replay)."""

    __slots__ = ("graph", "x", "mean", "var", "meter")

    def __init__(self, graph, x, mean, var, meter=None):
        self.graph, self.x, self.mean, self.var = graph, x, mean, var
        self.meter = meter if meter is not None else obs_cost.ReplayMeter("serve.batch")


def _bucket_body(predictor, x):
    """One padded bucket's predict: the metered entry function of the
    eager (CPU) path (``obs/cost.py`` keys its cost by this function and
    the operands' signature)."""
    return predictor._body(x)


class BucketedPredictor:
    """Build-once predict over a fixed bucket ladder.

    Wraps a :class:`ProjectedProcessRawPredictor` on its device
    (``raw.device``; ``None`` means ``cuda``) with device-resident
    operands and one build per bucket.  Requests above the top bucket are
    served in top-bucket chunks.  ``compile_counts`` maps bucket -> builds
    (graph captures on the card, first eager runs on the CPU)."""

    #: eager runs of the body on the side stream before a capture
    WARMUP_RUNS = 2

    def __init__(
        self,
        raw: ProjectedProcessRawPredictor,
        max_batch: int = 256,
        min_bucket: int = 8,
        buckets: Optional[Sequence[int]] = None,
        mean_only: bool = False,
    ):
        self._raw = raw
        self.mean_only = bool(mean_only) or raw.magic_matrix is None
        self.buckets = (
            tuple(sorted(set(int(b) for b in buckets))) if buckets is not None
            else bucket_sizes(max_batch, min_bucket)
        )
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.n_features = int(raw.active.shape[1])
        #: active-set size: with n_features, dtype and mean_only the shape
        #: the memory planner sizes a request from
        self.active_rows = int(raw.active.shape[0])
        self.device = resolve_device(raw.device)
        self._tdtype = working_dtype(self.device)
        self._dtype = np.dtype(np.float32 if self._tdtype == torch.float32 else np.float64)
        self.uses_graphs = self.device.type == "cuda"

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        self._theta = put(raw.theta, self._tdtype)
        self._active = put(raw.active, self._tdtype)
        self._mv = put(raw.magic_vector, torch.float64)
        self._mm = None if self.mean_only else put(raw.magic_matrix, torch.float64)
        # pad rows with the first active point, never zeros: a kernel may
        # be non-finite at the origin
        self._pad_row = np.asarray(raw.active[:1], dtype=self._dtype)
        self.compile_counts: Dict[int, int] = {}
        self._graphs: Dict[int, _BucketGraph] = {}
        self._pool = None
        self._warmed: set = set()
        self._frozen = False
        self._lock = threading.Lock()           # state: release and in-flight count
        self._dispatch_lock = threading.Lock()  # copy in -> replay -> copy out
        #: set by release(): new predicts refuse; the graphs and operands
        #: are freed once the last in-flight predict is done
        self.released = False
        self._active_calls = 0
        self._freed = False

    # --- the body --------------------------------------------------------
    def _body(self, x: torch.Tensor):
        """``(mean, var)`` of one padded bucket: the predictor's own
        ``_predict_block`` (var is None for a mean-only predictor)."""
        return self._raw._predict_block(self._theta, self._active, self._mv, self._mm, x)

    def _note_build(self, bucket: int) -> None:
        from spark_gp_tpu_torch.obs.runtime import telemetry

        self.compile_counts[bucket] = self.compile_counts.get(bucket, 0) + 1
        telemetry.inc("compile.bucket_traces", entry=f"bucket_{bucket}")

    def _capture(self, bucket: int) -> _BucketGraph:
        """Warm the body up eagerly on a side stream, then capture it into
        this predictor's pool over static buffers."""
        x = torch.as_tensor(np.broadcast_to(self._pad_row, (bucket, self.n_features)).copy(),
                            device=self.device).to(self._tdtype)
        try:
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.no_grad(), torch.cuda.stream(side):
                for _ in range(self.WARMUP_RUNS):
                    self._body(x)
            torch.cuda.current_stream(self.device).wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            meter = obs_cost.ReplayMeter("serve.batch")
            # no collection finalizes a dead graph on this thread mid-capture
            with torch.no_grad(), cuda_lib.collector_held(), \
                    torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"), \
                    meter.capturing():
                mean, var = self._body(x)
        except Exception as exc:  # classified-failure-site: typed, never eager
            raise GraphCaptureError(
                f"capturing the predict graph of bucket {bucket} failed: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
        return _BucketGraph(graph, x, mean, var, meter)

    # --- lifecycle -------------------------------------------------------
    def release(self) -> None:
        """Drop the graphs, their pool and the device operands (registry
        eviction).  New predicts refuse at once; the free waits for the
        last in-flight predict, so a batch that resolved this version
        completes against it.  Idempotent."""
        with self._lock:
            self.released = True
        self._maybe_free()

    def _maybe_free(self) -> None:
        with self._lock:
            free_now = self.released and self._active_calls == 0 and not self._freed
            if free_now:
                self._freed = True
        if free_now:
            with self._dispatch_lock:
                self._graphs.clear()
                self._pool = None
                self._theta = self._active = self._mv = self._mm = None

    def bucket_for(self, n: int) -> Optional[int]:
        """The smallest bucket >= n, or None past the top bucket."""
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def warmup(self) -> Dict[int, int]:
        """Build every bucket (capture its graph and replay it once on the
        card; run it once on the CPU), then freeze the set of buckets: a
        later build raises :class:`RecompileGuardError`.  Returns a copy
        of ``compile_counts``; idempotent."""
        for b in self.buckets:
            dummy = np.broadcast_to(self._pad_row, (b, self.n_features))
            self._dispatch(b, dummy, b)
            self._warmed.add(b)
        self._frozen = True
        return dict(self.compile_counts)

    def _dispatch(self, bucket: int, x_padded: np.ndarray, rows: int):
        """``(mean, var)`` numpy of the first ``rows`` of one padded bucket."""
        if self._theta is None:
            raise RuntimeError(
                "predictor was released (its registry version is retired); "
                "resolve the model again for the current version"
            )
        if self._frozen and bucket not in self._warmed:
            from spark_gp_tpu_torch.obs.runtime import telemetry

            telemetry.inc("compile.recompile_guard_trips", entry=f"bucket_{bucket}")
            raise RecompileGuardError(
                f"bucket {bucket} was not warmed; the set of buckets is frozen "
                f"to {sorted(self._warmed)}"
            )
        with self._dispatch_lock:
            if not self.uses_graphs:
                if bucket not in self.compile_counts:
                    self._note_build(bucket)
                with torch.no_grad():
                    mean, var = obs_cost.observed_call(
                        "serve.batch", _bucket_body, self,
                        torch.as_tensor(np.ascontiguousarray(x_padded)))
                return (mean[:rows].numpy(), None if var is None else var[:rows].numpy())
            entry = self._graphs.get(bucket)
            if entry is None:
                entry = self._graphs[bucket] = self._capture(bucket)
                self._note_build(bucket)
            try:
                entry.x.copy_(torch.from_numpy(np.ascontiguousarray(x_padded)))
                with entry.meter.replays(1):
                    if entry.meter.cost is None and obs_cost.cost_metering_enabled():
                        # captured while metering was off: one eager run of
                        # the body (answer discarded) prices an execution
                        with torch.no_grad(), entry.meter.capturing():
                            self._body(entry.x)
                    entry.graph.replay()
                mean = entry.mean[:rows].cpu().numpy()  # synchronizes
                var = None if entry.var is None else entry.var[:rows].cpu().numpy()
            except Exception as exc:  # classified-failure-site: typed, never eager
                raise GraphReplayError(
                    f"replaying the predict graph of bucket {bucket} failed: "
                    f"{type(exc).__name__}: {exc}"
                ) from exc
            return mean, var

    def _normalize(self, x_test) -> np.ndarray:
        x = np.asarray(x_test, dtype=self._dtype)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(
                f"x_test must be [t, {self.n_features}] (the model was fitted on "
                f"{self.n_features} features); got shape {tuple(np.shape(x_test))}"
            )
        return x

    def predict(self, x_test, chunk_oversize: bool = True):
        """``(mean [t], var [t])`` as numpy (``mean [t, C]`` for the
        multiclass model; ``var`` None for mean-only).  Pads up to the
        smallest covering bucket; requests past the top bucket are served
        in top-bucket chunks when ``chunk_oversize``, else raise
        :class:`BucketOverflowError`."""
        with self._lock:
            if self.released:
                raise RuntimeError(
                    "predictor was released (its registry version is retired); "
                    "resolve the model again for the current version"
                )
            self._active_calls += 1
        try:
            return self._predict_counted(x_test, chunk_oversize)
        finally:
            with self._lock:
                self._active_calls -= 1
            self._maybe_free()

    def _predict_counted(self, x_test, chunk_oversize: bool):
        x = self._normalize(x_test)
        t = x.shape[0]
        if t == 0:
            empty = np.zeros((0,) + tuple(np.shape(self._raw.magic_vector)[1:]), dtype=self._dtype)
            return empty, (None if self.mean_only else np.zeros(0, dtype=self._dtype))
        top = self.buckets[-1]
        if t > top and not chunk_oversize:
            raise BucketOverflowError(
                f"request of {t} rows exceeds the largest bucket {top} "
                "(pass chunk_oversize=True to serve it in chunks)"
            )
        means, vars_ = [], []
        for start in range(0, t, top):
            part = x[start:start + top]
            rows = part.shape[0]
            bucket = self.bucket_for(rows)
            if bucket > rows:
                part = np.concatenate(
                    [part, np.broadcast_to(self._pad_row, (bucket - rows, self.n_features))])
            mean, var = self._dispatch(bucket, part, rows)
            means.append(mean)
            vars_.append(var)
        mean = np.concatenate(means) if len(means) > 1 else means[0]
        if self.mean_only:
            return mean, None
        return mean, (np.concatenate(vars_) if len(vars_) > 1 else vars_[0])

    @property
    def dtype(self) -> np.dtype:
        """The one (numpy) dtype of every request and answer."""
        return self._dtype

    def padded_rows(self, t: int) -> int:
        """Device rows a ``t``-row request occupies after padding and
        top-bucket chunking (the occupancy denominator)."""
        if t <= 0:
            return 0
        top = self.buckets[-1]
        full, rem = divmod(t, top)
        return full * top + (self.bucket_for(rem) if rem else 0)

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())
