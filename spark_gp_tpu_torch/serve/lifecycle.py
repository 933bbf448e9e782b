"""Serve lifecycle: graceful drain, canary rollouts, hang watchdog and
memory-pressure admission (the port's copy of the JAX package's
``serve/lifecycle.py``).

* **graceful drain** -- SIGTERM / SIGINT (flag-only handlers) flip the
  server to draining: new submits are rejected with
  ``code=queue.shed.draining``, queued and in-flight work completes
  under a drain deadline, then the process exits 0;
* **canary rollout with auto-rollback** -- a new version takes a
  deterministic slice of default traffic while its answers are
  shadow-scored against the incumbent's on the same rows; a delta past
  the bar (the mixed lane's guard bar, 1e-2) or repeated
  errors roll it back and quarantine the version, enough clean scores
  promote it (the predecessor's graphs are released by retention);
* **hang watchdog** -- a dispatch past its hang deadline trips the
  model's breaker, fails the batch with ``code=exec.hung`` and replaces
  the batcher worker, so the other models keep serving;
* **memory-pressure admission** -- the allocator's bytes in use
  (``resilience/memplan.memory_in_use_bytes``) against a limit: low
  priority work is shed with ``code=queue.shed.memory`` before the
  allocator runs out, with high / low watermark hysteresis, and a
  request whose predicted bytes exceed the headroom is shed alone.

Transitions are span events and catalogued ``lifecycle.*`` /
``canary.*`` metrics (``obs/names.py``), surfaced by the server's
``health`` verb.  The canary's statistical-quality input
(``quality_lookup``) is the server's quality plane
(``obs/quality.ServeQualityPlane.alert_reason``): a policy with
``quality_guard`` rolls the candidate back while a miscalibration or
drift alert is active at promotion.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from spark_gp_tpu_torch.obs import trace as obs_trace
from spark_gp_tpu_torch.ops.precision import GUARD_BARS


class DrainingError(RuntimeError):
    """Submit rejected: the server is draining for shutdown — finish what
    is queued, take nothing new.  Clients fail over to another replica."""

    code = "queue.shed.draining"

    def __init__(self) -> None:
        super().__init__(
            "server is draining (shutdown in progress); retry against "
            "another replica"
        )


class MemoryPressureError(RuntimeError):
    """Submit shed by the memory-pressure admission gate: either this
    request's PREDICTED bytes (``resilience/memplan.py``) exceed the
    remaining headroom, or usage is above the high watermark — and the
    request's priority is below the floor.  Watermark sheds recover by
    hysteresis; predicted sheds re-admit as soon as headroom covers the
    request again."""

    code = "queue.shed.memory"

    def __init__(self, usage_bytes: float, limit_bytes: float,
                 predicted_bytes: Optional[float] = None) -> None:
        self.usage_bytes = float(usage_bytes)
        self.limit_bytes = float(limit_bytes)
        self.predicted_bytes = (
            None if predicted_bytes is None else float(predicted_bytes)
        )
        detail = (
            "low-priority work is shed until usage recovers"
            if predicted_bytes is None else
            f"this request's predicted {predicted_bytes / 1e6:.1f}MB "
            "exceeds the remaining headroom"
        )
        super().__init__(
            f"memory pressure: {usage_bytes / 1e6:.0f}MB in use against a "
            f"{limit_bytes / 1e6:.0f}MB limit; {detail}"
        )


class ExecHungError(RuntimeError):
    """A device execution exceeded its hang deadline.  The watchdog failed
    the batch and tripped the model's breaker; the wedged dispatch may
    still be burning a (replaced) worker thread underneath."""

    code = "exec.hung"

    def __init__(self, name: str, hang_timeout_s: float) -> None:
        super().__init__(
            f"execution for model {name!r} exceeded its {hang_timeout_s:.1f}s "
            "hang deadline; the model's breaker is now open"
        )


def install_drain_signals(
    flag: Optional[threading.Event] = None,
) -> Optional[threading.Event]:
    """Point SIGTERM *and* SIGINT at a drain flag (the serve CLI's
    shutdown path watches it).  Flag-only by construction, and
    deliberately NOT chaining the previous disposition: the default
    SIGINT handler raises ``KeyboardInterrupt``, which would abort the
    very drain the signal requested.  Returns the event, or None off the
    main thread (signal handlers cannot install there)."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return None
    from spark_gp_tpu_torch.parallel.coord import make_flag_handler

    flag = flag if flag is not None else threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        # the coordination plane's flag-only factory, with nothing chained
        signal.signal(sig, make_flag_handler(flag))
    return flag


# --------------------------------------------------------------------------
# hang watchdog
# --------------------------------------------------------------------------


class DispatchToken:
    """One in-flight ``_execute`` dispatch under watchdog observation."""

    __slots__ = ("model", "group", "deadline", "fired", "phase", "span")

    def __init__(
        self, model: str, group: list, deadline: float,
        phase: str = "predict",
    ) -> None:
        self.model = model
        self.group = group
        self.deadline = deadline
        #: the live serve.predict span of the dispatch, attached by the
        #: executor once it opens — a hang verdict's incident bundle
        #: renders it (still open: the wedged thread cannot close it)
        self.span = None
        #: "predict" for the candidate/stable dispatch itself, "shadow"
        #: for the INCUMBENT's scoring predict during a canary — the hang
        #: handler attributes the wedge to the right party
        self.phase = phase
        #: set (under the watchdog lock) when the hang verdict fired — the
        #: eventually-returning stale dispatch checks it to know its
        #: futures were already answered and its breaker outcome is void
        self.fired = False


class HangWatchdog:
    """Monotonic-clock watchdog over executor dispatches.

    The executor brackets every device dispatch with :meth:`begin` /
    :meth:`end`; a background thread polls the outstanding tokens and,
    when one exceeds its hang deadline, marks it fired and invokes
    ``on_hang(token)`` exactly once — from the WATCHDOG thread, because
    the dispatching thread is by definition wedged.  The stuck thread
    itself is never interrupted (a blocked device call cannot be); recovery
    means answering the futures, tripping the breaker, and replacing the
    worker.  Time is injectable so chaos tests drive the verdict without
    real 30-second hangs."""

    def __init__(
        self,
        on_hang: Callable[[DispatchToken], None],
        hang_timeout_s: float = 30.0,
        poll_interval_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if hang_timeout_s <= 0:
            raise ValueError("hang_timeout_s must be > 0")
        self._on_hang = on_hang
        self.hang_timeout_s = float(hang_timeout_s)
        self._poll_s = (
            float(poll_interval_s)
            if poll_interval_s is not None
            else max(0.005, min(0.05, self.hang_timeout_s / 4))
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._active: List[DispatchToken] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.trips = 0  # hang verdicts fired (monotonic)

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="gp-serve-watchdog", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        self._thread = None

    def begin(
        self, model: str, group: list, phase: str = "predict"
    ) -> DispatchToken:
        token = DispatchToken(
            model, group, self._clock() + self.hang_timeout_s, phase
        )
        with self._lock:
            self._active.append(token)
        return token

    def end(self, token: DispatchToken) -> None:
        with self._lock:
            try:
                self._active.remove(token)
            except ValueError:
                pass  # already removed by a fired verdict

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            now = self._clock()
            fired: List[DispatchToken] = []
            with self._lock:
                for token in list(self._active):
                    if now > token.deadline:
                        token.fired = True
                        self._active.remove(token)
                        fired.append(token)
            for token in fired:
                self.trips += 1
                try:
                    self._on_hang(token)
                except Exception:  # noqa: BLE001 — the watchdog must survive
                    import logging

                    logging.getLogger("spark_gp_tpu_torch").warning(
                        "hang watchdog handler raised", exc_info=True
                    )


# --------------------------------------------------------------------------
# memory-pressure admission
# --------------------------------------------------------------------------


def _default_memory_sampler() -> Optional[float]:
    """Bytes in use now (``resilience/memplan.memory_in_use_bytes``): the
    card's allocated bytes, the live host RSS on the CPU.  Live, not the
    lifetime peak, so that a crossed watermark does not latch shedding."""
    from spark_gp_tpu_torch.resilience import memplan

    return memplan.memory_in_use_bytes()


class MemoryAdmissionGate:
    """Shed lowest-priority submits before the runtime OOMs.

    Two constraints, both scoped to requests below ``priority_floor``:

    * **predicted headroom** (the memory plan, ``resilience/memplan.py``):
      ``check(priority, predicted_bytes=...)`` sheds when this request's
      predicted bytes exceed ``limit - usage`` — per-request admission
      against remaining headroom, recovering the moment headroom covers
      the next request (no latch to un-stick);
    * **watermark hysteresis** (the pre-plan behavior, and the fallback
      when no prediction is available): shedding starts when sampled
      usage crosses ``high_watermark * limit`` and stops only under
      ``low_watermark * limit`` — so the gate neither flaps at the bar
      nor needs an operator.  The two compose as a union: hysteresis
      guards against unattributed growth the per-request model cannot
      see, the prediction sheds the one oversized request before it
      lands (interaction table: docs/SERVING.md).

    Usage is sampled per request through the per-request-scoped read
    (``memplan.memory_in_use_bytes`` — live bytes, not the lifetime
    high-water mark), throttled by ``sample_interval_s`` so the hot path
    pays a clock read, not a device query (0 = sample every check).
    Disabled when no limit is configured (``limit_bytes`` arg or
    ``GP_SERVE_MEMORY_LIMIT_BYTES``)."""

    def __init__(
        self,
        limit_bytes: Optional[float] = None,
        high_watermark: float = 0.9,
        low_watermark: float = 0.75,
        priority_floor: int = 1,
        sample_interval_s: float = 0.25,
        sampler: Optional[Callable[[], Optional[float]]] = None,
        clock: Callable[[], float] = time.monotonic,
        on_state: Optional[Callable[[bool], None]] = None,
    ) -> None:
        if limit_bytes is None:
            import os

            raw = os.environ.get("GP_SERVE_MEMORY_LIMIT_BYTES", "").strip()
            if raw:
                try:
                    limit_bytes = float(raw)
                except ValueError:
                    limit_bytes = None
        if not 0 < low_watermark <= high_watermark <= 1.0:
            raise ValueError(
                "need 0 < low_watermark <= high_watermark <= 1.0"
            )
        self.limit_bytes = (
            None if not limit_bytes or limit_bytes <= 0 else float(limit_bytes)
        )
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.priority_floor = int(priority_floor)
        self._sample_interval_s = float(sample_interval_s)
        self._sampler = sampler if sampler is not None else _default_memory_sampler
        self._clock = clock
        self._on_state = on_state
        self._lock = threading.Lock()
        self._sampled_at = -float("inf")
        self._usage = 0.0
        self._shedding = False
        self.sheds = 0  # submits rejected (monotonic)
        self.plan_sheds = 0  # of which: predicted-headroom sheds

    @property
    def enabled(self) -> bool:
        return self.limit_bytes is not None

    def check(self, priority: int = 0,
              predicted_bytes: Optional[float] = None) -> None:
        if self.limit_bytes is None:
            return
        changed = None
        with self._lock:
            now = self._clock()
            if now - self._sampled_at >= self._sample_interval_s:
                self._sampled_at = now
                usage = self._sampler()
                if usage is not None:
                    self._usage = float(usage)
                    if (
                        not self._shedding
                        and self._usage >= self.high_watermark * self.limit_bytes
                    ):
                        self._shedding = changed = True
                    elif (
                        self._shedding
                        and self._usage <= self.low_watermark * self.limit_bytes
                    ):
                        self._shedding = False
                        changed = False
            shedding = self._shedding
            usage = self._usage
            # per-request predicted-headroom admission (the memory plan):
            # would THIS request's predicted bytes fit what remains?
            over_headroom = (
                predicted_bytes is not None
                and usage + float(predicted_bytes) > self.limit_bytes
            )
            shed = (shedding or over_headroom) and priority < self.priority_floor
            if shed:
                self.sheds += 1
                if over_headroom and not shedding:
                    self.plan_sheds += 1
        if changed is not None:
            obs_trace.add_event(
                "lifecycle.memory_pressure",
                shedding=changed, usage_bytes=usage,
            )
            if self._on_state is not None:
                self._on_state(changed)
        if shed:
            if over_headroom and not shedding:
                from spark_gp_tpu_torch.obs.runtime import telemetry

                telemetry.inc("plan.shed")
            raise MemoryPressureError(
                usage, self.limit_bytes,
                predicted_bytes if over_headroom else None,
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.limit_bytes is not None,
                "limit_bytes": self.limit_bytes,
                "usage_bytes": self._usage,
                "shedding": self._shedding,
                "sheds": self.sheds,
                "plan_sheds": self.plan_sheds,
                "high_watermark": self.high_watermark,
                "low_watermark": self.low_watermark,
                "priority_floor": self.priority_floor,
            }


# --------------------------------------------------------------------------
# canary rollout
# --------------------------------------------------------------------------


#: the mixed lane's guard bar (``ops/precision.GUARD_BARS["mixed"]``): its
#: calibrated "predictions drifted more than numerics can explain" bar, the
#: canary's default shadow-delta bar
MIXED_GUARD_BAR = GUARD_BARS["mixed"]


def _default_predict_bar() -> float:
    return MIXED_GUARD_BAR


@dataclass
class CanaryPolicy:
    """When to trust a candidate version.

    ``fraction`` of default traffic routes to the candidate; every
    candidate answer is shadow-scored against the incumbent on the same
    rows.  One shadow delta past ``delta_predict_bar``, or ``max_errors``
    raising dispatches, rolls back; ``promote_after`` clean shadow scores
    promote.

    ``quality_guard=True`` adds the statistical health plane
    (``obs/quality.py``) as a SECOND promotion input next to the shadow
    score: at the moment the clean-score count clears the bar, an active
    miscalibration/drift alert on the model vetoes the promotion and
    rolls the candidate back instead — a candidate whose means match the
    incumbent but whose σ's are dishonest must not be promoted on the
    mean-delta evidence alone."""

    fraction: float = 0.1
    delta_predict_bar: float = field(default_factory=_default_predict_bar)
    max_errors: int = 3
    promote_after: int = 20
    quality_guard: bool = False

    def __post_init__(self) -> None:
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError("canary fraction must be in (0, 1]")
        if self.max_errors < 1 or self.promote_after < 1:
            raise ValueError("max_errors and promote_after must be >= 1")


class _Canary:
    __slots__ = (
        "name", "candidate", "incumbent", "policy",
        "routed", "shadow_scores", "clean_scores", "errors", "max_delta",
    )

    def __init__(self, name, candidate, incumbent, policy):
        self.name = name
        self.candidate = candidate
        self.incumbent = incumbent
        self.policy = policy
        self.routed = 0
        self.shadow_scores = 0
        self.clean_scores = 0
        self.errors = 0
        self.max_delta = 0.0

    def describe(self) -> dict:
        return {
            "candidate": self.candidate,
            "incumbent": self.incumbent,
            "fraction": self.policy.fraction,
            "routed": self.routed,
            "shadow_scores": self.shadow_scores,
            "clean_scores": self.clean_scores,
            "errors": self.errors,
            "max_delta": self.max_delta,
            "promote_after": self.policy.promote_after,
        }


class CanaryController:
    """Routes, shadow-scores and adjudicates canary versions.

    One active canary per model name.  Routing is deterministic (the
    k-th default-traffic request goes to the candidate exactly when
    ``floor(k*f)`` increments — no RNG, so tests and replays see the
    same slice).  Verdicts run on the batcher thread right after the
    candidate's dispatch: rollback retires + quarantines the candidate
    via the registry, promotion moves the latest pointer and lets
    bounded retention evict the predecessor."""

    def __init__(self, registry, metrics, quality_lookup=None) -> None:
        self._registry = registry
        self._metrics = metrics
        #: optional ``name -> active-alert reason | None`` callable (the
        #: serve quality plane's verdict) consulted when a policy opts
        #: into ``quality_guard``
        self._quality_lookup = quality_lookup
        self._lock = threading.Lock()
        self._canaries: dict = {}
        #: (name, version) -> reason; rolled-back versions are quarantined
        #: so a redeploy must mint a NEW version (the registry never
        #: reuses numbers) rather than silently resurrect the bad one.
        #: Bounded (insertion-ordered, oldest dropped past the cap): a
        #: long-lived server with automated redeploys must not grow this
        #: — and every health payload that carries it — forever.
        self.quarantined: dict = {}
        self._max_quarantined = 64

    def active(self, name: str) -> Optional[dict]:
        with self._lock:
            canary = self._canaries.get(name)
            return None if canary is None else canary.describe()

    def is_candidate(self, name: str, version) -> bool:
        with self._lock:
            canary = self._canaries.get(name)
            return canary is not None and canary.candidate == version

    def is_quarantined(self, name: str, version) -> bool:
        with self._lock:
            return (name, version) in self.quarantined

    def start(self, name: str, candidate: int, incumbent: int,
              policy: CanaryPolicy) -> None:
        with self._lock:
            if name in self._canaries:
                raise ValueError(
                    f"model {name!r} already has an active canary "
                    f"(candidate v{self._canaries[name].candidate}); promote "
                    "or roll it back first"
                )
            self._canaries[name] = _Canary(name, candidate, incumbent, policy)
        self._metrics.inc("canary.starts")
        self._metrics.set_gauge(f"canary.active.{name}", 1.0)
        obs_trace.add_event(
            "canary.start", model=name, candidate=candidate,
            incumbent=incumbent, fraction=policy.fraction,
        )

    def route(self, name: str) -> Optional[int]:
        """Version to serve this default-traffic request: the candidate
        for the canary slice, None (= latest) otherwise."""
        with self._lock:
            canary = self._canaries.get(name)
            if canary is None:
                return None
            canary.routed += 1
            f = canary.policy.fraction
            take = int(canary.routed * f) > int((canary.routed - 1) * f)
            if not take:
                return None
            candidate = canary.candidate
        self._metrics.inc("canary.routed")
        return candidate

    # -- verdicts (batcher thread) ----------------------------------------
    def observe_success(self, name: str, version, x, mean) -> None:
        """Shadow-score one successful candidate dispatch against the
        incumbent on the SAME rows, then adjudicate."""
        with self._lock:
            canary = self._canaries.get(name)
            if canary is None or canary.candidate != version:
                return
            incumbent = canary.incumbent
            bar = canary.policy.delta_predict_bar
        try:
            ref_entry = self._registry.get(name, incumbent)
        except KeyError:
            # the incumbent vanished.  Two ways that happens: (a) an
            # operator retired it — the candidate is the only thing
            # serving, so resolve the state machine by promoting it;
            # (b) a NEWER direct register/reload evicted it through
            # retention — promoting would drag the latest pointer
            # BACKWARDS onto the stale candidate, so cancel instead
            try:
                latest = self._registry.get(name).version
            except KeyError:
                latest = None
            if latest is not None and latest > version:
                self._rollback(
                    name, version, reason="superseded by a newer version"
                )
            else:
                self._promote(name, version)
            return
        try:
            ref_mean, _ = ref_entry.predict(x)
        except Exception:  # noqa: BLE001 — scoring is advisory, not service
            return
        delta = float(
            np.max(np.abs(np.asarray(mean) - np.asarray(ref_mean)))
            / (np.max(np.abs(np.asarray(ref_mean))) + 1e-12)
        )
        self._metrics.inc("canary.shadow_scores")
        promote = False
        with self._lock:
            canary = self._canaries.get(name)
            if canary is None or canary.candidate != version:
                return
            canary.shadow_scores += 1
            canary.max_delta = max(canary.max_delta, delta)
            if delta > bar:
                breach = True
            else:
                breach = False
                canary.clean_scores += 1
                promote = canary.clean_scores >= canary.policy.promote_after
        if breach:
            self._metrics.inc("canary.breaches")
            self._rollback(
                name, version,
                reason=f"shadow delta {delta:.3e} > guard bar {bar:.3e}",
            )
        elif promote:
            quality_veto = None
            if (
                canary.policy.quality_guard
                and self._quality_lookup is not None
            ):
                # the optional quality-guard input (obs/quality.py): a
                # candidate that cleared the mean-delta bar while the
                # model's served distributions are under an active
                # miscalibration/drift alert is NOT promotable on that
                # evidence — roll back instead
                quality_veto = self._quality_lookup(name)
            if quality_veto is not None:
                self._rollback(
                    name, version,
                    reason=f"quality alert active at promotion: {quality_veto}",
                )
            else:
                self._promote(name, version)

    def cancel(self, name: str, reason: str = "cancelled") -> bool:
        """Abort an active canary without a verdict (a direct reload or
        register superseded the experiment): the candidate is retired and
        quarantined like a rollback.  Returns False when no canary was
        active."""
        with self._lock:
            canary = self._canaries.get(name)
            if canary is None:
                return False
            version = canary.candidate
        self._rollback(name, version, reason=reason)
        return True

    def observe_error(self, name: str, version) -> None:
        """A candidate dispatch raised; enough of them roll back."""
        with self._lock:
            canary = self._canaries.get(name)
            if canary is None or canary.candidate != version:
                return
            canary.errors += 1
            rollback = canary.errors >= canary.policy.max_errors
        self._metrics.inc("canary.errors")
        if rollback:
            self._rollback(
                name, version, reason="elevated error rate on the candidate"
            )

    # -- transitions ------------------------------------------------------
    def _rollback(self, name: str, version, reason: str) -> None:
        with self._lock:
            canary = self._canaries.pop(name, None)
            if canary is None:
                return
            self.quarantined[(name, version)] = reason
            while len(self.quarantined) > self._max_quarantined:
                self.quarantined.pop(next(iter(self.quarantined)))
        # retire AFTER the canary stops routing: a submit racing this
        # rollback lands on the incumbent, not a half-removed candidate
        self._registry.retire(name, version)
        self._metrics.inc("canary.rollbacks")
        self._metrics.set_gauge(f"canary.active.{name}", 0.0)
        obs_trace.add_event(
            "canary.rollback", model=name, version=version, reason=reason
        )

    def _promote(self, name: str, version) -> None:
        with self._lock:
            canary = self._canaries.pop(name, None)
            if canary is None:
                return
        self._registry.promote(name, version)
        self._metrics.inc("canary.promotions")
        self._metrics.set_gauge(f"canary.active.{name}", 0.0)
        obs_trace.add_event("canary.promote", model=name, version=version)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active": {
                    name: canary.describe()
                    for name, canary in self._canaries.items()
                },
                "quarantined": {
                    f"{name}:{version}": reason
                    for (name, version), reason in self.quarantined.items()
                },
            }
