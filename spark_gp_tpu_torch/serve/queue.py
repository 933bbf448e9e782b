"""Bounded request queue with micro-batch coalescing (the port's copy of
the JAX package's ``serve/queue.py``).

A one-row request uses a sliver of the card, but holding requests to build
big batches adds queueing delay.  Micro-batch coalescing resolves it:
dispatch at once when idle, and while the card is busy let a short
max-wait window (default 2 ms) collect whatever arrives, so that the
batch size follows the load.

Failures shed load, never stall:

* the queue is bounded: a full queue rejects the submit with
  :class:`QueueFullError` at the door;
* every request carries a deadline on the queue's clock (injectable, so
  tests expire deadlines without sleeping): one that expires while queued
  is completed with :class:`DeadlineExpiredError` (the
  ``queue.shed.deadline`` metric) and never costs a dispatch;
* a batch whose execution raises is re-run one request at a time, so a
  poisoned request fails alone.
"""

from __future__ import annotations

import concurrent.futures
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from spark_gp_tpu_torch.obs import trace as obs_trace


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity; retry with backoff
    or add serving capacity."""

    #: machine-readable shed class, surfaced by the CLI error payloads
    code = "queue.shed.backpressure"


class RequestTimeoutError(TimeoutError):
    """The request's deadline expired before a result was produced."""


class DeadlineExpiredError(RequestTimeoutError):
    """The request's deadline expired while it sat in the QUEUE — shed
    load under overload.  Structurally distinct from a client-side wait
    timeout (:class:`RequestTimeoutError` from ``ServeFuture.result``) so
    dashboards can tell "the server is saturated" (this error + the
    ``queue.shed.deadline`` counter) from "the client gave up"."""

    code = "queue.shed.deadline"


class ServeFuture(concurrent.futures.Future):
    """Single-request result holder: the stdlib Future (thread-safe,
    double-set protected) with the serve error vocabulary — ``set_error``
    and a ``result`` that times out as :class:`RequestTimeoutError`."""

    def set_error(self, error: BaseException) -> None:
        self.set_exception(error)

    def result(self, timeout: Optional[float] = None):
        try:
            return super().result(timeout)
        except concurrent.futures.TimeoutError:
            # the builtin TimeoutError since Python 3.11: a request's own
            # error of that family (DeadlineExpiredError) is re-raised as
            # it is, only a wait that lapsed becomes RequestTimeoutError
            if self.done():
                raise
            raise RequestTimeoutError(
                "no result within the wait timeout (server overloaded or "
                "stopped?)"
            ) from None


@dataclass
class PredictRequest:
    """One enqueued predict: rows for a named model + bookkeeping."""

    model_key: Tuple[str, Optional[int]]  # (name, version|None=latest)
    x: np.ndarray
    future: ServeFuture = field(default_factory=ServeFuture)
    enqueued_at: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None  # monotonic seconds, None = never
    # set by the worker when this request is re-executed singly to isolate
    # a poisoned batch: the executor must treat the run as a PAYLOAD probe
    # (skip model-level circuit-breaker gating/accounting), or one poisoned
    # episode would multi-count failures and trip the breaker mid-loop,
    # erroring the innocent batchmates still waiting their turn
    isolation_retry: bool = False
    # True when the version in model_key was picked by the CANARY ROUTER
    # rather than the client: only routed requests may be re-served from
    # the stable latest after a rollback — a client-pinned version is a
    # contract (serve THAT one or fail)
    routed: bool = False
    # client-supplied correlation id (the serve CLI's "request_id" field):
    # echoed in the reply, stamped on the serve.predict span, and carried
    # into any incident bundle a hang verdict dumps — the client's handle
    # for cross-process trace stitching
    request_id: Optional[str] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and (
            now if now is not None else time.monotonic()
        ) > self.deadline


_SENTINEL = object()


class MicroBatchQueue:
    """Bounded queue + coalescing worker.

    ``execute(batch)`` — supplied by the server — receives a list of
    same-model :class:`PredictRequest` and must complete every future.
    The worker groups a coalesced window by model key, so mixed-model
    traffic still batches per model.
    """

    def __init__(
        self,
        execute: Callable[[List[PredictRequest]], None],
        capacity: int = 1024,
        max_wait_s: float = 0.002,
        max_batch_rows: int = 1024,
        on_timeout: Optional[Callable[[int], None]] = None,
        on_poison: Optional[Callable[[int], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        #: the clock request deadlines are read on (injectable: tests
        #: expire deadlines without sleeping); the coalescing window and
        #: the drain barrier wait on real time
        self.clock = clock
        self._execute = execute
        self._on_timeout = on_timeout
        self._on_poison = on_poison
        self._q: _queue.Queue = _queue.Queue(maxsize=capacity)
        self.capacity = capacity
        self.max_wait_s = float(max_wait_s)
        self.max_batch_rows = int(max_batch_rows)
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        # worker generation: replace_worker() bumps it to ABANDON a wedged
        # worker (stuck inside execute — the hang-watchdog case) and hand
        # dispatching to a fresh thread; the stale worker notices the bump
        # when (if ever) its stuck call returns, and exits instead of
        # double-consuming.  _in_flight counts the CURRENT generation's
        # dispatches for wait_idle (drain).
        self._gen = 0
        self._gen_lock = threading.Lock()
        self._in_flight = 0

    # -- producer side ----------------------------------------------------
    def submit(self, request: PredictRequest) -> ServeFuture:
        if self._stopping.is_set():
            raise RuntimeError("queue is stopped")
        try:
            self._q.put_nowait(request)
        except _queue.Full:
            raise QueueFullError(
                f"request queue at capacity ({self.capacity}); shedding "
                "load — retry with backoff or raise --capacity"
            ) from None
        if self._stopping.is_set():
            # stop() completed between the gate above and the put: the
            # worker and stop()'s own drain sweep may both be gone, so
            # nothing would ever complete this future — sweep the queue
            # here rather than leave the caller blocked forever
            self._fail_leftovers()
        return request.future

    def depth(self) -> int:
        return self._q.qsize()

    # -- worker side ------------------------------------------------------
    def start(self) -> None:
        """Start (or restart) the worker.  ``stop``/``start`` are
        symmetric: a stopped queue restarted here accepts and serves
        requests again."""
        # _thread handoffs happen under _gen_lock so a concurrent stop()
        # can never observe a created-but-not-yet-started Thread (join on
        # one raises) — replace_worker keeps the same invariant
        with self._gen_lock:
            if self._thread is not None:
                return
            self._stopping.clear()
            self._in_flight = 0
            self._thread = threading.Thread(
                target=self._loop, args=(self._gen,),
                name="gp-serve-batcher", daemon=True,
            )
            self._thread.start()

    def replace_worker(self) -> None:
        """Abandon the current worker (wedged in an execute the hang
        watchdog just failed) and start a replacement, so the OTHER
        models' queued work dispatches again.  The stuck thread is left
        blocked (a wedged device call cannot be interrupted) and exits on
        its own when the call eventually returns."""
        with self._gen_lock:
            self._gen += 1  # abandon the wedged worker unconditionally
            self._in_flight = 0
            if self._stopping.is_set() or self._thread is None:
                # a hang verdict racing stop(): the queue is (being) shut
                # down — spawning a replacement would repopulate _thread
                # and break a later stop/start cycle; leftovers are failed
                # by stop()'s own sweep
                return
            gen = self._gen
            self._thread = threading.Thread(
                target=self._loop, args=(gen,),
                name=f"gp-serve-batcher-{gen}", daemon=True,
            )
            self._thread.start()

    def wait_idle(self, timeout: float) -> bool:
        """Block until no request is queued or in flight (the drain
        barrier); False when the timeout lapses first."""
        deadline = time.monotonic() + float(timeout)
        while True:
            with self._gen_lock:
                busy = self._in_flight
            if busy == 0 and self._q.qsize() == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the worker; with ``drain`` (default) queued requests are
        still executed, without it they fail fast with shutdown errors."""
        with self._gen_lock:  # see start(): atomic _thread handoff
            thread = self._thread
        if thread is None:
            return
        if not drain:
            self._stopping.set()
        self._q.put(_SENTINEL)  # blocking put: always deliverable
        thread.join(timeout)
        with self._gen_lock:
            self._thread = None
        self._stopping.set()
        # whatever is left after the join window fails explicitly
        self._fail_leftovers()

    def _fail_leftovers(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except _queue.Empty:
                break
            if item is not _SENTINEL:
                item.future.set_error(RuntimeError("server shut down"))

    def _loop(self, my_gen: int) -> None:
        while True:
            if my_gen != self._gen:
                return  # abandoned by replace_worker: a successor dispatches
            try:
                first = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if first is _SENTINEL:
                return
            if self._stopping.is_set():
                first.future.set_error(RuntimeError("server shut down"))
                continue
            with self._gen_lock:
                if my_gen == self._gen:
                    self._in_flight += 1
            batch = [first]
            rows = first.x.shape[0]
            # coalescing window opens at first dequeue: an idle server
            # dispatches a lone request after at most max_wait_s, a busy
            # one fills toward max_batch_rows
            deadline = time.monotonic() + self.max_wait_s
            saw_sentinel = False
            try:
                while rows < self.max_batch_rows:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except _queue.Empty:
                        break
                    if nxt is _SENTINEL:
                        saw_sentinel = True
                        break
                    batch.append(nxt)
                    rows += nxt.x.shape[0]
                self._run_batch(batch)
            finally:
                with self._gen_lock:
                    # an abandoned worker's counter was already reset by
                    # replace_worker — only the live generation decrements
                    if my_gen == self._gen:
                        self._in_flight = max(0, self._in_flight - 1)
            if saw_sentinel:
                return

    def _run_batch(self, batch: List[PredictRequest]) -> None:
        # one span per coalesced window: the batcher thread's trace root,
        # under which the executor's serve.predict span (and any breaker /
        # isolation events) nest — a request's server-side story is one tree
        with obs_trace.span("serve.batch", requests=len(batch)):
            self._run_batch_inner(batch)

    def _run_batch_inner(self, batch: List[PredictRequest]) -> None:
        # shed already-expired requests BEFORE spending a dispatch on them
        now = self.clock()
        live: dict = {}
        expired = 0
        for req in batch:
            if req.expired(now):
                expired += 1
                req.future.set_error(
                    DeadlineExpiredError(
                        "deadline expired while queued (server overloaded)"
                    )
                )
                continue
            live.setdefault(req.model_key, []).append(req)
        if expired:
            # the trace event records the shed whether or not a metrics
            # callback is wired — the timeline must not depend on it
            obs_trace.add_event("queue.shed.deadline", count=expired)
            if self._on_timeout is not None:
                self._on_timeout(expired)
        for group in live.values():
            try:
                self._execute(group)
            except BaseException as exc:  # noqa: BLE001 — worker must survive
                from spark_gp_tpu_torch.resilience.breaker import BreakerOpenError

                if len(group) == 1 or isinstance(exc, BreakerOpenError):
                    # a breaker rejection is a BATCH-level verdict: every
                    # request in the group would be rejected identically,
                    # so per-request isolation would only burn N futile
                    # execute calls and mislabel the episode as poison
                    for req in group:
                        if not req.future.done():
                            req.future.set_error(exc)
                    continue
                # poisoned-request isolation: ONE bad request (a payload
                # the compiled predict chokes on) must not fail its
                # innocent batchmates.  Re-execute each request singly —
                # failure-path-only cost — so exactly the offender(s)
                # receive the error and everyone else an answer.
                poisoned = 0
                late = 0
                for req in group:
                    if req.future.done():
                        continue
                    if req.expired(self.clock()):
                        # the serial re-execution takes time of its own: a
                        # request whose deadline lapsed mid-isolation gets
                        # the same deadline shed as the normal dispatch
                        # path, not a dispatch nobody is waiting for
                        late += 1
                        req.future.set_error(
                            DeadlineExpiredError(
                                "deadline expired while queued "
                                "(server overloaded)"
                            )
                        )
                        continue
                    req.isolation_retry = True
                    try:
                        self._execute([req])
                    except BaseException as exc_one:  # noqa: BLE001
                        poisoned += 1
                        if not req.future.done():
                            req.future.set_error(exc_one)
                    finally:
                        req.isolation_retry = False
                if late and self._on_timeout is not None:
                    self._on_timeout(late)
                if poisoned:
                    obs_trace.add_event(
                        "queue.isolation",
                        poisoned=poisoned,
                        model=group[0].model_key[0],
                    )
                    if self._on_poison is not None:
                        self._on_poison(poisoned)
