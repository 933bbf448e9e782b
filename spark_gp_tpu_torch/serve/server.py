"""The serving core: registry, micro-batch queue and metrics in one object
(the port's copy of the JAX package's ``serve/server.py``).

:class:`GPServeServer` owns what the CLI (and any embedding application)
needs: register models (each load captures every bucket's CUDA graph
before the version serves), accept requests from any thread through
:meth:`submit`, coalesce them into micro-batches on the one batcher
thread, and answer through
:class:`~spark_gp_tpu_torch.serve.queue.ServeFuture`.  Each dispatch runs
under the model's circuit breaker and the hang watchdog.  One batcher
thread is deliberate: launches are serialized on the card's stream
anyway, and a single consumer makes the coalescing window race-free.
The server runs on ``cuda`` unless ``device="cpu"`` is given, and raises
without a GPU otherwise.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from spark_gp_tpu_torch.obs import trace as obs_trace
from spark_gp_tpu_torch.resilience.breaker import BreakerOpenError, CircuitBreaker
from spark_gp_tpu_torch.serve.lifecycle import (
    CanaryController,
    CanaryPolicy,
    DrainingError,
    ExecHungError,
    HangWatchdog,
    MemoryAdmissionGate,
    MemoryPressureError,
)
from spark_gp_tpu_torch.serve.metrics import ServingMetrics
from spark_gp_tpu_torch.serve.queue import (
    MicroBatchQueue,
    PredictRequest,
    QueueFullError,
    ServeFuture,
)
from spark_gp_tpu_torch.serve.registry import ModelRegistry, ServableModel


def _not_ported(what: str, item):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md queue 1, item {item})"
    )


class GPServeServer:
    """Online scorer over a :class:`ModelRegistry`.

    >>> server = GPServeServer(max_batch=128)
    >>> server.register("airfoil", "model.npz")
    >>> server.start()
    >>> fut = server.submit("airfoil", x)      # any thread
    >>> mean, var = fut.result(timeout=1.0)
    >>> server.stop()
    """

    def __init__(
        self,
        max_batch: int = 256,
        min_bucket: int = 8,
        buckets: Optional[Sequence[int]] = None,
        mean_only: bool = False,
        capacity: int = 1024,
        max_wait_ms: float = 2.0,
        request_timeout_ms: Optional[float] = 1000.0,
        metrics: Optional[ServingMetrics] = None,
        max_versions: int = 2,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 5.0,
        hang_timeout_s: Optional[float] = 30.0,
        memory_limit_bytes: Optional[float] = None,
        drain_deadline_s: float = 30.0,
        replica_id: Optional[str] = None,
        quality: Optional[bool] = None,
        device=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if quality:
            raise _not_ported("the serve quality plane (calibration, drift, observe)", "10b")
        # replica identity (health verb): explicit arg > GP_REPLICA_ID env
        # > a pid-derived default, stable for the process's lifetime
        self.replica_id = (
            str(replica_id) if replica_id is not None
            else os.environ.get("GP_REPLICA_ID") or f"replica-{os.getpid()}"
        )
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # one circuit breaker per model NAME (not version: a reload that
        # fixes the model closes the breaker through its half-open probe)
        self._breakers: dict = {}
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset_s = float(breaker_reset_s)
        #: the clock request deadlines and latencies are read on
        #: (injectable: tests expire deadlines without sleeping)
        self._clock = clock
        self.registry = ModelRegistry(
            max_batch=max_batch,
            min_bucket=min_bucket,
            buckets=buckets,
            mean_only=mean_only,
            metrics=self.metrics,
            max_versions=max_versions,
            device=device,
        )
        #: where the models are served (``None`` means ``cuda``)
        self.device = self.registry.device
        self._request_timeout_s = (
            None if request_timeout_ms is None else request_timeout_ms / 1e3
        )
        self._queue = MicroBatchQueue(
            execute=self._execute,
            capacity=capacity,
            max_wait_s=max_wait_ms / 1e3,
            max_batch_rows=max_batch,
            # "timeouts" is the aggregate; queue.shed.deadline the shed
            # class dashboards tell apart from backpressure
            on_timeout=lambda n: (
                self.metrics.inc("timeouts", n),
                self.metrics.inc("queue.shed.deadline", n),
            ),
            on_poison=lambda n: self.metrics.inc("queue.poisoned", n),
            clock=clock,
        )
        self._started = False
        # lifecycle layer (serve/lifecycle.py): process state machine,
        # hang watchdog, memory-pressure admission, canary controller
        self._state = "starting"
        self._drain_deadline_s = float(drain_deadline_s)
        self._hang_timeout_s = (
            None if hang_timeout_s is None or hang_timeout_s <= 0
            else float(hang_timeout_s)
        )
        self._watchdog = (
            None if self._hang_timeout_s is None
            else HangWatchdog(self._on_hang, self._hang_timeout_s)
        )
        self.memory_gate = MemoryAdmissionGate(
            limit_bytes=memory_limit_bytes,
            on_state=lambda shedding: self.metrics.set_gauge(
                "lifecycle.memory_pressure", 1.0 if shedding else 0.0
            ),
        )
        #: the statistical quality plane waits for its port (item 10b)
        self.quality = None
        self.canaries = CanaryController(self.registry, self.metrics)

    def _breaker_for(self, name: str) -> CircuitBreaker:
        breaker = self._breakers.get(name)
        if breaker is None:
            # registry access is already lock-protected; breaker creation
            # races are benign (last write wins before any failure counts)
            breaker = self._breakers[name] = CircuitBreaker(
                name=name,
                failure_threshold=self._breaker_threshold,
                reset_timeout_s=self._breaker_reset_s,
            )
        return breaker

    @property
    def request_timeout_s(self) -> Optional[float]:
        """The default per-request deadline in seconds (None = disabled)."""
        return self._request_timeout_s

    # -- lifecycle --------------------------------------------------------
    def register(
        self,
        name: str,
        path: str,
        canary_fraction: Optional[float] = None,
        canary_policy: Optional[CanaryPolicy] = None,
        **kw,
    ) -> ServableModel:
        """Load and publish a model.  With ``canary_fraction`` (and an
        already-serving incumbent) the new version is published as a
        CANARY instead of an instant hot swap: it takes that fraction of
        default traffic, shadow-scored against the incumbent, and is
        auto-promoted or auto-rolled-back by the controller
        (serve/lifecycle.py)."""
        if canary_fraction is None and canary_policy is None:
            # a DIRECT register during an active canary supersedes the
            # experiment: cancel it first, or retention would evict the
            # canary's incumbent and the orphaned controller state could
            # later drag the latest pointer backwards
            self.canaries.cancel(name, reason="superseded by direct register")
            return self.registry.register(name, path, **kw)
        try:
            incumbent = self.registry.get(name).version
        except KeyError:
            # first version of a name: nothing to canary against — a
            # plain register IS the safe rollout
            return self.registry.register(name, path, **kw)
        policy = canary_policy if canary_policy is not None else CanaryPolicy(
            fraction=canary_fraction
        )
        entry = self.registry.register(name, path, make_latest=False, **kw)
        try:
            self.canaries.start(name, entry.version, incumbent, policy)
        except ValueError:
            # a canary is already active for this name: retire the version
            # we just built rather than leak an unroutable warmed entry
            self.registry.retire(name, entry.version)
            raise
        return entry

    def rollout(
        self,
        name: str,
        path: Optional[str] = None,
        canary_fraction: float = 0.1,
        canary_policy: Optional[CanaryPolicy] = None,
    ) -> ServableModel:
        """Canary-reload: like ``registry.reload`` but through the canary
        gate (default source: the incumbent's own path)."""
        source = path or self.registry.get(name).path
        return self.register(
            name, source,
            canary_fraction=canary_fraction, canary_policy=canary_policy,
        )

    def reload(self, name: str, path: Optional[str] = None) -> ServableModel:
        """Plain hot-swap reload THROUGH the lifecycle layer: an active
        canary for the name is cancelled first (direct reload supersedes
        the experiment), then the registry hot-swaps as usual.  Callers
        going straight to ``registry.reload`` bypass that cancellation."""
        self.canaries.cancel(name, reason="superseded by direct reload")
        return self.registry.reload(name, path)

    def start(self) -> None:
        self._queue.start()
        if self._watchdog is not None:
            self._watchdog.start()
        self._started = True
        self._state = "serving"
        self.metrics.set_gauge("lifecycle.draining", 0.0)

    def ready(self) -> bool:
        return (
            self._started
            and self._state == "serving"
            and bool(self.registry.names())
        )

    def stop(self, drain: bool = True) -> None:
        self._queue.stop(drain=drain)
        if self._watchdog is not None:
            self._watchdog.stop()
        self._started = False
        self._state = "stopped"
        # begin_drain() -> stop() (without drain()) must not leave the
        # draining gauge latched at 1 on a stopped server
        self.metrics.set_gauge("lifecycle.draining", 0.0)

    def begin_drain(self) -> None:
        """Flip to draining: every NEW submit is rejected with
        ``code=queue.shed.draining`` while queued and in-flight work keeps
        completing.  Idempotent; :meth:`drain` waits out the queue."""
        if self._state in ("draining", "stopped"):
            return
        self._state = "draining"
        self.metrics.inc("lifecycle.drains")
        self.metrics.set_gauge("lifecycle.draining", 1.0)
        obs_trace.add_event("lifecycle.drain_begin")

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Graceful shutdown: reject new work, complete what is queued and
        in flight (bounded by the drain deadline), then stop.  Returns
        True when everything completed inside the deadline; past it the
        leftovers are failed fast (shutdown errors) so no client blocks on
        a future nobody will complete."""
        deadline_s = (
            self._drain_deadline_s if deadline_s is None else float(deadline_s)
        )
        started = time.monotonic()
        self.begin_drain()
        drained = self._queue.wait_idle(deadline_s)
        # past-deadline leftovers are failed by stop(drain=False)
        self._queue.stop(drain=drained)
        if self._watchdog is not None:
            self._watchdog.stop()
        self._started = False
        self._state = "stopped"
        self.metrics.observe("lifecycle.drain_s", time.monotonic() - started)
        self.metrics.set_gauge("lifecycle.draining", 0.0)
        obs_trace.add_event("lifecycle.drain_end", drained=drained)
        return drained

    # -- request path -----------------------------------------------------
    def submit(
        self,
        name: str,
        x,
        version: Optional[int] = None,
        timeout_ms: Optional[float] = None,
        priority: int = 0,
        request_id: Optional[str] = None,
    ) -> ServeFuture:
        """Enqueue a predict; returns immediately with a future.

        Shape errors, drain/memory shedding and backpressure surface
        HERE, in the caller's thread — an invalid or shed request must
        never occupy queue capacity or a batch slot.  ``priority`` only
        matters under memory pressure: requests at or above the gate's
        priority floor keep being admitted while lower ones are shed.
        """
        if self._state == "draining":
            self.metrics.inc("shed")
            self.metrics.inc("queue.shed.draining")
            raise DrainingError()
        routed = None
        if version is None:
            # canary slice: a deterministic fraction of default traffic
            # is pinned to the candidate version (lifecycle.py); explicit
            # versions bypass routing — the client asked for THAT one
            routed = self.canaries.route(name)
        try:
            entry = self.registry.get(
                name, routed if version is None else version
            )  # KeyError for unknowns
        except KeyError:
            if routed is None:
                raise
            # the canary rolled back between route and resolve: this is
            # default traffic — serve it from the (stable) latest
            entry = self.registry.get(name)
        breaker = self._breaker_for(name)
        if breaker.state == CircuitBreaker.OPEN:
            # fail fast at the door while the breaker cools: no queue
            # slot, no batch dispatch, microsecond latency.  Half-open
            # probes are admitted (and accounted) in _execute.
            self.metrics.inc("shed.breaker")
            raise BreakerOpenError(name, breaker.reset_timeout_s)
        try:
            # predicted-per-request admission (resilience/memplan.py):
            # THIS request's bytes at its padded bucket shape against
            # remaining headroom — BEFORE the dtype cast below, so a
            # shed request never allocates the very memory being
            # protected.  The row count is read from the payload's own
            # shape (no conversion); with planning off or an unreadable
            # payload the gate falls back to its watermark hysteresis,
            # the pre-plan behavior.
            self.memory_gate.check(
                priority,
                # priced only when a limit is configured: the disabled
                # gate (the common case) must cost zero on the hot path
                predicted_bytes=(
                    self._predicted_request_bytes(entry, x)
                    if self.memory_gate.enabled else None
                ),
            )
        except MemoryPressureError:
            self.metrics.inc("shed")
            self.metrics.inc("queue.shed.memory")
            raise
        # cast straight to the predictor's working dtype: one conversion
        # on the hot path, and _normalize's later asarray is then a no-op
        x = np.asarray(x, dtype=entry.predictor.dtype)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != entry.predictor.n_features:
            raise ValueError(
                f"model {name!r} expects [t, {entry.predictor.n_features}] "
                f"inputs; got shape {tuple(x.shape)}"
            )
        if not np.isfinite(x).all():
            # poisoned payload rejected at the door: it must never occupy
            # queue capacity or share a coalesced batch with healthy rows
            self.metrics.inc("shed.poison")
            raise ValueError(
                f"request for model {name!r} contains non-finite values"
            )
        timeout_s = (
            timeout_ms / 1e3 if timeout_ms is not None
            else self._request_timeout_s
        )
        request = PredictRequest(
            # pin the CONCRETE version resolved at submit: a reload
            # between submit and dispatch must not re-route this request
            # to a model it was never validated against (the registry's
            # in-flight hot-swap invariant)
            model_key=(name, entry.version if version is None else version),
            x=x,
            enqueued_at=self._clock(),
            deadline=(
                None if timeout_s is None else self._clock() + timeout_s
            ),
            routed=routed is not None and entry.version == routed,
            request_id=None if request_id is None else str(request_id),
        )
        try:
            future = self._queue.submit(request)
        except Exception as exc:  # hygiene-ok: shed accounting only — re-raised
            self.metrics.inc("shed")
            if isinstance(exc, QueueFullError):
                self.metrics.inc("queue.shed.backpressure")
            raise
        self.metrics.inc("requests")
        self.metrics.inc("requests_rows", x.shape[0])
        self.metrics.set_gauge("queue_depth", self._queue.depth())
        return future

    @staticmethod
    def _predicted_request_bytes(entry, x) -> Optional[float]:
        """Margined predicted bytes of this request's dispatch, or None
        (gate disabled / planning off / unreadable payload — the gate
        then runs its watermark leg only).  Deliberately allocation-free:
        the row count comes from the payload's OWN shape (ndarray
        ``.shape``, or ``len`` of a sequence-of-rows), never from an
        ``asarray`` conversion — this runs before the cast precisely so
        shed requests cost nothing."""
        if not entry or entry.predictor is None:
            return None
        from spark_gp_tpu_torch.resilience import memplan

        try:
            shape = getattr(x, "shape", None)
            if shape is not None:
                rows = int(shape[0]) if len(shape) == 2 else 1
            elif x and isinstance(x[0], (list, tuple, np.ndarray)):
                rows = len(x)
            else:
                rows = 1
            return memplan.predict_request_bytes(entry.predictor, rows)
        except Exception:  # noqa: BLE001 — sizing is advisory; the
            # validation below owns rejecting malformed payloads
            return None

    def predict(
        self,
        name: str,
        x,
        version: Optional[int] = None,
        timeout_ms: Optional[float] = None,
    ):
        """Blocking convenience: submit + wait."""
        wait_s = (
            None
            if (timeout_ms is None and self._request_timeout_s is None)
            # queue deadline + one batch window of slack for the dispatch
            else ((timeout_ms / 1e3) if timeout_ms is not None
                  else self._request_timeout_s) + 5.0
        )
        return self.submit(name, x, version, timeout_ms).result(wait_s)

    # -- delayed-label feedback (any thread) ------------------------------
    def observe(self, name: str, request_id: str, y) -> dict:
        """Delayed-label feedback (the JAX package's ``observe`` verb):
        the statistical quality plane it feeds is not ported yet."""
        raise _not_ported("the serve quality plane's observe verb", "10b")

    # -- batch execution (batcher thread) ---------------------------------
    def _execute(self, group: List[PredictRequest]) -> None:
        """Score one coalesced same-model group: concatenate rows, one
        bucketed predict, split the answers back per request.

        The model's circuit breaker brackets the predict: an open breaker
        rejects the group instantly (half-open admits one probe), a
        raising predict counts toward tripping it, and a success closes
        it — so a model whose predict is broken stops consuming
        batcher dispatches after ``breaker_threshold`` failures while
        every other model keeps serving."""
        name, version = group[0].model_key
        breaker = self._breaker_for(name)
        # a canary candidate's failures must not poison the NAME-level
        # breaker the stable version serves behind — its error budget is
        # the canary controller's (rollback after max_errors), and the
        # rollout bar is "zero failed requests on the stable version"
        is_canary = self.canaries.is_candidate(name, version)
        # isolation re-runs are PAYLOAD probes of an already-counted batch
        # failure: gating/accounting them would multi-count one poisoned
        # episode, trip the breaker mid-loop, and error the innocent
        # batchmates still waiting their turn (queue.py isolation_retry)
        guarded = not group[0].isolation_retry and not is_canary
        if guarded:
            try:
                breaker.before_call()  # raises BreakerOpenError while open
            except BreakerOpenError:
                obs_trace.add_event("breaker.reject", model=name)
                raise
        try:
            try:
                entry = self.registry.resolve(group[0].model_key)
            except KeyError:
                if not self.canaries.is_quarantined(name, version) or not all(
                    req.routed for req in group
                ):
                    # a client-PINNED version is a contract: serve that
                    # one or fail.  (A mixed routed/pinned group fails
                    # here as a batch; the queue's isolation pass then
                    # re-runs each singly and the routed ones recover.)
                    raise
                # requests ROUTED to a canary that rolled back while they
                # sat in the queue: this is default traffic — re-serve it
                # from the stable latest instead of failing it on a
                # version the client never asked for by name.  The stable
                # dispatch re-enters the breaker gate it skipped at
                # canary admission (a guarded=False re-serve would let
                # repeated stable failures bypass all breaker accounting).
                entry = self.registry.get(name)
                is_canary = False
                if not group[0].isolation_retry:
                    breaker.before_call()  # BreakerOpenError rejects batch
                    guarded = True
            rows = [req.x.shape[0] for req in group]
            total = sum(rows)
            x = (
                group[0].x if len(group) == 1
                else np.concatenate([req.x for req in group], axis=0)
            )
        except BaseException:  # hygiene-ok: admission release only — re-raised
            # pre-dispatch failure (e.g. the pinned version was evicted):
            # not the model's predict misbehaving — release the admission
            # (a half-open probe permit would otherwise leak and reject
            # the model forever) without counting a breaker outcome
            if guarded:
                breaker.abort_call()
            raise
        started = time.monotonic()
        # the hang watchdog observes the dispatch from OUTSIDE this thread
        # (which is exactly what wedges on a hang); a fired token means the
        # futures were already failed and the worker replaced — this
        # thread's outcome is void (lifecycle.py)
        token = (
            self._watchdog.begin(name, group)
            if self._watchdog is not None else None
        )
        request_ids = [
            req.request_id for req in group if req.request_id is not None
        ]
        try:
            with obs_trace.span(
                "serve.predict", model=name, version=group[0].model_key[1],
                rows=total, requests=len(group),
                isolation_retry=group[0].isolation_retry,
                **({"request_ids": request_ids} if request_ids else {}),
            ) as predict_span:
                if token is not None and getattr(
                    predict_span, "span_id", 0
                ):  # real span only (tracing off yields the noop stub)
                    # a hang verdict renders this (still-open) span in its
                    # incident bundle — the wedged dispatch's own evidence
                    token.span = predict_span
                mean, var = entry.predict(x)
        except BaseException as exc:  # classified-failure-site: counted via classify_failure, re-raised
            if token is not None:
                self._watchdog.end(token)
                if token.fired:
                    return  # already adjudicated as hung; stale outcome
            self.metrics.inc("predict.failures")
            if isinstance(exc, Exception):
                # classify the raw failure into the closed taxonomy
                # (fallback.failures.* counters): an operator can tell a
                # fleet of OOMing predicts from a broken model without
                # reading stack traces.  Counting only — the predict-side
                # degradation ladder lives inside the predictor (ppa.py);
                # what reaches here already exhausted or bypassed it.
                from spark_gp_tpu_torch.resilience import fallback

                fallback.record_failure(exc, entry="serve")
            if is_canary:
                self.canaries.observe_error(name, entry.version)
            if guarded:
                trips_before = breaker.trip_count
                breaker.record_failure()
                if breaker.trip_count > trips_before:
                    self.metrics.inc("breaker.trips")
                    self.metrics.set_gauge(f"breaker.open.{name}", 1.0)
                    obs_trace.add_event("breaker.open", model=name)
            raise
        if token is not None:
            self._watchdog.end(token)
            if token.fired:
                return  # the watchdog answered for us; do not double-set
        if guarded:
            was_broken = breaker.state != CircuitBreaker.CLOSED
            breaker.record_success()
            self.metrics.set_gauge(f"breaker.open.{name}", 0.0)
            if was_broken:
                obs_trace.add_event("breaker.close", model=name)
        if is_canary:
            # shadow-score against the incumbent on the same rows, then
            # let the controller adjudicate (promote / rollback) — on
            # this thread, so a verdict is in force before the next batch.
            # The scoring dispatch gets its OWN watchdog token: an
            # incumbent that wedges here would otherwise pin the batcher
            # with no outstanding token — the exact hole the watchdog
            # exists to close.
            token = (
                self._watchdog.begin(name, group, phase="shadow")
                if self._watchdog is not None else None
            )
            try:
                self.canaries.observe_success(name, entry.version, x, mean)
            finally:
                if token is not None:
                    self._watchdog.end(token)
            if token is not None and token.fired:
                return  # futures already failed, worker already replaced
        elapsed = time.monotonic() - started
        padded = entry.predictor.padded_rows(total)
        self.metrics.inc("batches")
        self.metrics.inc("padded_rows", padded - total)
        self.metrics.observe("batch_rows", total)
        self.metrics.observe("batch_requests", len(group))
        self.metrics.observe("batch_occupancy", total / max(padded, 1))
        self.metrics.observe("batch_predict_s", elapsed)
        self.metrics.set_gauge("queue_depth", self._queue.depth())
        now = self._clock()
        offset = 0
        for req, t in zip(group, rows):
            if not req.future.done():  # a hang verdict may have answered
                req.future.set_result(
                    (
                        mean[offset : offset + t],
                        None if var is None else var[offset : offset + t],
                    )
                )
            offset += t
            self.metrics.observe("request_latency_s", now - req.enqueued_at)

    def _on_hang(self, token) -> None:
        """Watchdog verdict (runs on the WATCHDOG thread — the batcher is
        the thing that is wedged): fail the stuck batch with
        ``code=exec.hung``, trip the model's breaker so further dispatches
        are rejected at the door, and replace the batcher worker so every
        other model's queued work starts moving again."""
        name = token.model
        version = token.group[0].model_key[1]
        self.metrics.inc("exec.hung")
        self.metrics.inc("lifecycle.watchdog_trips")
        if token.phase != "shadow" and self.canaries.is_candidate(
            name, version
        ):
            # a hung CANDIDATE counts against the canary error budget
            # (enough of them roll it back), never the name-level breaker
            # the stable version serves behind — same isolation as the
            # raising-canary path in _execute.  A "shadow" token is the
            # opposite party: the wedged call is the INCUMBENT's scoring
            # predict — blaming the (healthy, already-answered) candidate
            # would roll back every redeploy while the broken incumbent
            # kept serving, so that case falls through to the breaker.
            self.canaries.observe_error(name, version)
        else:
            breaker = self._breaker_for(name)
            trips_before = breaker.trip_count
            breaker.trip()
            if breaker.trip_count > trips_before:
                self.metrics.inc("breaker.trips")
                self.metrics.set_gauge(f"breaker.open.{name}", 1.0)
        error = ExecHungError(name, self._watchdog.hang_timeout_s)
        # the hang's incident bundle (obs/recorder.py): the wedged
        # dispatch's still-open serve.predict span, the request ids it
        # was serving, and the recorder's event history — dumped from the
        # watchdog thread, the only one guaranteed to still be moving
        from spark_gp_tpu_torch.obs import recorder as obs_recorder

        obs_recorder.dump_incident(
            reason="exec.hung", exc=error, failure_class="exec.hung",
            root=getattr(token.span, "root_span", None),
            extra={
                "model": name,
                "version": version,
                "phase": token.phase,
                # the wedged dispatch's own (still-open) span, verbatim —
                # it cannot be in the closed-span tree, by definition
                "hung_span": (
                    None if token.span is None else token.span.to_dict()
                ),
                "request_ids": [
                    req.request_id for req in token.group
                    if req.request_id is not None
                ],
                "rows": int(sum(req.x.shape[0] for req in token.group)),
            },
        )
        for req in token.group:
            if not req.future.done():
                req.future.set_error(error)
        self.metrics.inc("predict.failures")
        self._queue.replace_worker()

    # -- introspection ----------------------------------------------------
    def lifecycle_snapshot(self) -> dict:
        """The lifecycle layer's state in one dict (health verb + CLI)."""
        return {
            "state": self._state,
            "draining": self._state == "draining",
            "drain_deadline_s": self._drain_deadline_s,
            "watchdog": {
                "enabled": self._watchdog is not None,
                "hang_timeout_s": self._hang_timeout_s,
                "trips": 0 if self._watchdog is None else self._watchdog.trips,
            },
            "memory": self.memory_gate.snapshot(),
            "canary": self.canaries.snapshot(),
        }

    def snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["models"] = self.registry.describe()
        snap["queue"] = {
            "depth": self._queue.depth(),
            "capacity": self._queue.capacity,
            "max_wait_ms": self._queue.max_wait_s * 1e3,
            "max_batch_rows": self._queue.max_batch_rows,
        }
        snap["breakers"] = {
            # copy first: reader threads insert breakers concurrently
            name: b.snapshot() for name, b in sorted(dict(self._breakers).items())
        }
        snap["lifecycle"] = self.lifecycle_snapshot()
        snap["quality"] = {"enabled": False}
        return snap

    def openmetrics(self) -> str:
        """The OpenMetrics/Prometheus exposition page for this server
        (obs/expo.py), with runtime compile/memory telemetry merged in.
        Point-in-time series are refreshed first so a scrape always
        carries the queue gauge and one breaker gauge per model — even
        before the first trip."""
        from spark_gp_tpu_torch.obs.expo import render_openmetrics
        from spark_gp_tpu_torch.obs.runtime import telemetry

        self.metrics.set_gauge("queue_depth", self._queue.depth())
        for name in self.registry.names():
            breaker = self._breaker_for(name)
            self.metrics.set_gauge(
                f"breaker.open.{name}",
                0.0 if breaker.state == CircuitBreaker.CLOSED else 1.0,
            )
        telemetry.sample_memory()
        return render_openmetrics(self.metrics, telemetry.snapshot())

    def health(self) -> dict:
        """The ``/healthz`` answer: liveness, readiness, and per-component
        degradation — cheap enough for an orchestrator to poll.

        ``status``: ``"ok"`` (ready, all breakers closed),
        ``"degraded"`` (serving, but at least one model's breaker is
        open/half-open, the queue is above 90% capacity, or the memory
        gate is shedding), ``"draining"`` (shutdown in progress: finish
        queued work, route new traffic elsewhere) or ``"unready"`` (not
        started / no models).  A degraded server still answers requests
        for its healthy models — that is the point.
        """
        breakers = {
            # copy first: reader threads insert breakers concurrently
            name: b.snapshot() for name, b in sorted(dict(self._breakers).items())
        }
        depth = self._queue.depth()
        queue_pressure = depth / max(self._queue.capacity, 1)
        broken = sorted(
            name for name, b in breakers.items()
            if b["state"] != CircuitBreaker.CLOSED
        )
        lifecycle = self.lifecycle_snapshot()
        if lifecycle["draining"]:
            status = "draining"
        elif not self.ready():
            status = "unready"
        elif broken or queue_pressure > 0.9 or lifecycle["memory"]["shedding"]:
            status = "degraded"
        else:
            status = "ok"
        try:
            from spark_gp_tpu_torch.obs.runtime import build_info

            identity_build = build_info()
        except Exception:  # noqa: BLE001 — health must answer regardless
            identity_build = {}
        replica = {
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "build_info": identity_build,
            "device": str(self.device),
        }
        return {
            "replica": replica,
            "status": status,
            "ready": self.ready(),
            "models": self.registry.names(),
            "broken_models": broken,
            "quality": {"enabled": False},
            "breakers": breakers,
            "lifecycle": lifecycle,
            "queue": {
                "depth": depth,
                "capacity": self._queue.capacity,
                "pressure": queue_pressure,
            },
            "counters": {
                key: self.metrics.counter(key)
                for key in (
                    "requests", "batches", "shed", "timeouts",
                    "queue.shed.deadline", "queue.shed.backpressure",
                    "queue.shed.draining", "queue.shed.memory",
                    "queue.poisoned", "shed.breaker", "shed.poison",
                    "predict.failures", "breaker.trips", "exec.hung",
                )
            },
        }
