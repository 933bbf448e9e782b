"""Circuit breaker: isolate a faulting model without taking down the server
(the port's copy of the JAX package's ``resilience/breaker.py``).

A model whose predict raises (corrupted operands after a bad reload, a
wedged device, an injected fault) must not consume batcher dispatches or
drag down the other models of the process.  The three-state breaker:

* **closed** -- normal service; consecutive failures are counted, a
  success resets the count;
* **open** -- after ``failure_threshold`` consecutive failures every call
  is rejected at once with :class:`BreakerOpenError` for
  ``reset_timeout_s``;
* **half-open** -- after the cooldown exactly one probe is let through;
  success closes the breaker, failure re-opens it for another cooldown.

Thread-safe; the clock is injectable, so tests drive the transitions
without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class BreakerOpenError(RuntimeError):
    """Request rejected without dispatch: the target's breaker is open."""

    #: machine-readable class on the wire (serve/codes.py): clients back
    #: off, the fleet router fails over to the next ring replica
    code = "shed.breaker"

    def __init__(self, name: str, retry_after_s: float) -> None:
        self.retry_after_s = max(0.0, retry_after_s)
        super().__init__(
            f"circuit breaker for {name!r} is open (target failing); "
            f"retry after {self.retry_after_s:.3f}s"
        )


class CircuitBreaker:
    """Per-target breaker guarding an unreliable call path."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        name: str = "target",
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s < 0:
            raise ValueError("reset_timeout_s must be >= 0")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.trip_count = 0  # times the breaker has opened (monotonic)

    # -- gate -------------------------------------------------------------
    def before_call(self) -> None:
        """Admission check; raises :class:`BreakerOpenError` when open.

        In half-open state admits exactly one concurrent probe — further
        callers are rejected until that probe reports back."""
        with self._lock:
            if self._state == self.OPEN:
                elapsed = self._clock() - self._opened_at
                if elapsed < self.reset_timeout_s:
                    raise BreakerOpenError(
                        self.name, self.reset_timeout_s - elapsed
                    )
                self._state = self.HALF_OPEN
                self._probe_in_flight = False
            if self._state == self.HALF_OPEN:
                if self._probe_in_flight:
                    raise BreakerOpenError(
                        self.name,
                        self.reset_timeout_s,
                    )
                self._probe_in_flight = True

    def abort_call(self) -> None:
        """Release an admission taken by :meth:`before_call` without
        recording an outcome — for failures BEFORE the guarded call runs
        (e.g. the target no longer exists).  Without this a half-open
        probe that dies pre-dispatch would pin ``_probe_in_flight`` and
        reject the target forever."""
        with self._lock:
            self._probe_in_flight = False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._probe_in_flight = False

    def trip(self) -> None:
        """Force the breaker open NOW, regardless of the consecutive-failure
        count — for out-of-band verdicts like the serve hang watchdog
        (``serve/lifecycle.py``), where one wedged execution is already
        proof the target must stop receiving dispatches."""
        with self._lock:
            if self._state != self.OPEN:
                self.trip_count += 1
            self._state = self.OPEN
            self._opened_at = self._clock()
            self._consecutive_failures = max(
                self._consecutive_failures, self.failure_threshold
            )
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            now_open = (
                self._state == self.HALF_OPEN
                or self._consecutive_failures >= self.failure_threshold
            )
            if now_open:
                if self._state != self.OPEN:
                    self.trip_count += 1
                self._state = self.OPEN
                self._opened_at = self._clock()
            self._probe_in_flight = False

    # -- introspection ----------------------------------------------------
    @property
    def state(self) -> str:
        """Current state, promoting open -> half_open after the cooldown
        (read-only view — the promotion is committed by before_call)."""
        with self._lock:
            if (
                self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s
            ):
                return self.HALF_OPEN
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            state = self._state
            if (
                state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s
            ):
                state = self.HALF_OPEN
            return {
                "state": state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
                "trips": self.trip_count,
            }
