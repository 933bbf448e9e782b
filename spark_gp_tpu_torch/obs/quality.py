"""Statistical health plane: online calibration, drift, per-expert quality
(the port's copy of the JAX package's ``obs/quality.py``, plain numpy, so
both packages give the same numbers on the same stream).

The systems observability layers (obs/trace, obs/runtime, obs/recorder)
watch latency, memory, compiles and failures — none of them can tell an
operator whether the *distributions* a GP serves are honest.  The
product-of-experts aggregation is known to turn overconfident as the
expert count grows (Healing Products of GP experts, arxiv 2102.07106;
expert selection, arxiv 2102.01496), and an overconfident σ ships silent
damage: downstream consumers trust intervals that do not cover.  This
module makes miscalibration and input drift first-class, alertable,
chaos-provable observables:

* :class:`QualityMonitor` — a bounded-memory streaming calibration
  monitor over ``(μ, σ², y)`` triples: standardized-residual z statistics
  (mean/variance), a fixed-bin PIT histogram, nominal-coverage counters
  for the 50/90/99% central intervals, and a rolling predictive NLL.
  Statistics accumulate both process-lifetime totals and fixed-size
  windows; a **multi-window verdict engine** flips the monitor to
  ``alert`` only after ``breach_windows`` CONSECUTIVE breached windows
  (one noisy window never pages), and a clean window recovers it;
* :class:`DriftMonitor` — scores incoming covariate rows against the
  fit-time :func:`summarize_covariates` summary (per-dim moments + an
  active-set-centroid distance sketch stamped into the saved model's
  ``provenance_json``), with the same multi-window verdict semantics;
* :class:`PendingRing` — the bounded ``request_id -> (μ, σ²)`` join
  buffer behind the serve ``observe`` verb: delayed ground-truth labels
  arrive minutes after the predictions they grade, so the server parks
  each answered request's distribution (keyed by the client's
  ``request_id``) until the label shows up.  Joins are idempotent — a
  re-sent observation of an already-joined id is a counted no-op, never
  a double count — and eviction is strictly oldest-first;
* :class:`ServeQualityPlane` — the per-model composition the server
  owns: monitors + pending ring + metric emission (``quality.*`` /
  ``drift.*`` families, ``obs/names.py``) + the one-line verdict the
  ``health`` verb and the canary guard consume.

Everything here is plain numpy on the host — no device work, no CUDA
graph — and every per-observation step is O(1) against fixed-size state,
so the monitor can run always-on in production (the JAX package holds it
under 2% of the serve path; ``chip_smoke.py``'s ``quality`` phase times
the port's closed loop with it on and off).  Chaos proof:
``chaos.miscalibrate`` (σ-scaling) and ``chaos.drift_inputs`` (covariate
shift) must each trip their alert within a bounded number of
observations while a clean seeded twin never does
(``tests/test_torch_quality.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np

#: two-sided standard-normal bounds of the nominal central intervals the
#: coverage counters track: P(|z| <= bound) = level
COVERAGE_LEVELS: Dict[str, float] = {
    "50": 0.6744897501960817,
    "90": 1.6448536269514722,
    "99": 2.5758293035489004,
}

#: fixed PIT histogram bin count (uniform [0, 1] bins)
PIT_BINS = 20

_LOG_2PI = math.log(2.0 * math.pi)

#: schema marker of the covariate summary stamped into provenance_json
COVARIATE_SUMMARY_VERSION = 1


class ObserveError(RuntimeError):
    """Base of the ``observe`` verb's classified failures (``code`` is a
    wire code from :mod:`spark_gp_tpu_torch.serve.codes`)."""

    code = "observe.unknown_request"


class UnknownRequestError(ObserveError):
    """The observed ``request_id`` has no pending prediction: it was
    never served with a ``request_id``, its entry aged out of the
    bounded pending ring, or the label went to the wrong replica."""

    code = "observe.unknown_request"

    def __init__(self, request_id: str) -> None:
        super().__init__(
            f"no pending prediction for request_id {request_id!r} "
            "(never served here, or evicted from the pending ring)"
        )


class QualityDisabledError(ObserveError):
    """``observe`` reached a server whose quality plane is disabled."""

    code = "observe.disabled"

    def __init__(self) -> None:
        super().__init__(
            "the statistical quality plane is disabled on this server "
            "(GP_SERVE_QUALITY=0 or --quality 0)"
        )


_erf = np.vectorize(math.erf, otypes=[np.float64])


def _phi(z: np.ndarray) -> np.ndarray:
    """Standard-normal CDF, vectorized (the PIT transform)."""
    return 0.5 * (1.0 + _erf(np.asarray(z) / math.sqrt(2.0)))


# --------------------------------------------------------------------------
# streaming calibration monitor
# --------------------------------------------------------------------------


class _WindowAccumulator:
    """One fixed-size window's running sums (reset on close)."""

    __slots__ = ("n", "z_sum", "z2_sum", "nll_sum", "cov", "pit")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.z_sum = 0.0
        self.z2_sum = 0.0
        self.nll_sum = 0.0
        self.cov = {level: 0 for level in COVERAGE_LEVELS}
        self.pit = np.zeros(PIT_BINS, dtype=np.int64)


class QualityMonitor:
    """Streaming calibration statistics with a multi-window verdict.

    ``observe(mean, var, y)`` folds a batch of graded predictions in;
    every ``window`` observations one window closes and is judged against
    four independent breach tests (each sized so a WELL-SPECIFIED model
    breaches with negligible probability — the thresholds are k-sigma
    bounds under the null, not tuning knobs):

    * **coverage** — for each nominal level p in 50/90/99%, the window's
      empirical coverage must sit within ``coverage_sigmas`` binomial
      standard errors of p;
    * **z-variance** — the window mean of z² must sit within
      ``zvar_sigmas * sqrt(2/window)`` of 1 (the χ² null) — THE
      overconfidence signal: a model whose σ is 2× too small shows
      mean z² ≈ 4;
    * **z-mean** — |window mean of z| must stay under
      ``zmean_sigmas / sqrt(window)`` (systematic bias);
    * **PIT uniformity** — the window's PIT histogram χ² statistic must
      stay under ``pit_chi2_bar`` (df = bins - 1 = 19; the default 60 is
      far past the 1e-4 tail).

    A window failing any test is *breached*; ``breach_windows``
    consecutive breached windows flip the monitor to **alert** (the
    sustained-breach semantics — one weird burst of labels never pages),
    and one clean window recovers it.  All state is O(bins + history):
    bounded memory by construction.

    Thread-safe: the serve reader threads and the batcher feed one
    instance concurrently.
    """

    def __init__(
        self,
        window: int = 128,
        breach_windows: int = 2,
        history: int = 16,
        coverage_sigmas: float = 4.0,
        zvar_sigmas: float = 6.0,
        zmean_sigmas: float = 5.0,
        pit_chi2_bar: float = 60.0,
        min_sigma: float = 1e-12,
    ) -> None:
        if window < 8:
            raise ValueError("window must be >= 8 observations")
        if breach_windows < 1:
            raise ValueError("breach_windows must be >= 1")
        self.window = int(window)
        self.breach_windows = int(breach_windows)
        self.coverage_sigmas = float(coverage_sigmas)
        self.zvar_sigmas = float(zvar_sigmas)
        self.zmean_sigmas = float(zmean_sigmas)
        self.pit_chi2_bar = float(pit_chi2_bar)
        self.min_sigma = float(min_sigma)
        self._lock = threading.Lock()
        # lifetime totals
        self.n = 0
        self._z_sum = 0.0
        self._z2_sum = 0.0
        self._nll_sum = 0.0
        self._cov = {level: 0 for level in COVERAGE_LEVELS}
        self._pit = np.zeros(PIT_BINS, dtype=np.int64)
        # windowing
        self._win = _WindowAccumulator()
        self._recent: deque = deque(maxlen=max(history, breach_windows))
        self._consecutive_breaches = 0
        self.windows_closed = 0
        self.alert = False
        self.alert_reasons: List[str] = []

    # -- feeding -----------------------------------------------------------
    def observe(self, mean, var, y) -> List[dict]:
        """Fold a batch of graded predictions in; returns the verdicts of
        any windows this batch closed (empty for most calls)."""
        mean = np.asarray(mean, dtype=np.float64).reshape(-1)
        var = np.asarray(var, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if not (mean.shape == var.shape == y.shape):
            raise ValueError(
                f"mean/var/y must align; got {mean.shape}/{var.shape}/{y.shape}"
            )
        sigma = np.sqrt(np.maximum(var, self.min_sigma**2))
        z = (y - mean) / sigma
        pit = _phi(z)
        nll = 0.5 * (_LOG_2PI + 2.0 * np.log(sigma) + z * z)
        bins = np.minimum((pit * PIT_BINS).astype(np.int64), PIT_BINS - 1)
        closed: List[dict] = []
        with self._lock:
            for i in range(z.shape[0]):
                zi = float(z[i])
                self.n += 1
                self._z_sum += zi
                self._z2_sum += zi * zi
                self._nll_sum += float(nll[i])
                self._pit[bins[i]] += 1
                win = self._win
                win.n += 1
                win.z_sum += zi
                win.z2_sum += zi * zi
                win.nll_sum += float(nll[i])
                win.pit[bins[i]] += 1
                abs_z = abs(zi)
                for level, bound in COVERAGE_LEVELS.items():
                    if abs_z <= bound:
                        self._cov[level] += 1
                        win.cov[level] += 1
                if win.n >= self.window:
                    closed.append(self._close_window_locked())
        return closed

    # -- verdicts ----------------------------------------------------------
    def _close_window_locked(self) -> dict:
        win = self._win
        w = float(win.n)
        reasons: List[str] = []
        for level in COVERAGE_LEVELS:
            p = float(level) / 100.0
            emp = win.cov[level] / w
            sigma_b = math.sqrt(p * (1.0 - p) / w)
            if abs(emp - p) > self.coverage_sigmas * sigma_b:
                reasons.append(
                    f"coverage_{level}: {emp:.3f} vs nominal {p:.3f}"
                )
        z_mean = win.z_sum / w
        z2_mean = win.z2_sum / w
        if abs(z2_mean - 1.0) > self.zvar_sigmas * math.sqrt(2.0 / w):
            reasons.append(f"z_variance: mean z^2 = {z2_mean:.3f}")
        if abs(z_mean) > self.zmean_sigmas / math.sqrt(w):
            reasons.append(f"z_mean: {z_mean:.3f}")
        expected = w / PIT_BINS
        chi2 = float(np.sum((win.pit - expected) ** 2) / expected)
        if chi2 > self.pit_chi2_bar:
            reasons.append(f"pit_chi2: {chi2:.1f}")
        verdict = {
            "n": win.n,
            "z_mean": z_mean,
            "z_std": math.sqrt(max(z2_mean - z_mean * z_mean, 0.0)),
            "nll_mean": win.nll_sum / w,
            "coverage": {
                level: win.cov[level] / w for level in COVERAGE_LEVELS
            },
            "pit_chi2": chi2,
            "breached": bool(reasons),
            "reasons": reasons,
        }
        self.windows_closed += 1
        self._recent.append(verdict)
        if reasons:
            self._consecutive_breaches += 1
        else:
            self._consecutive_breaches = 0
        was_alert = self.alert
        self.alert = self._consecutive_breaches >= self.breach_windows
        if self.alert:
            self.alert_reasons = reasons
        elif was_alert:
            self.alert_reasons = []
        verdict["alert"] = self.alert
        verdict["alert_changed"] = self.alert != was_alert
        win.reset()
        return verdict

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            n = self.n
            if n == 0:
                totals = {
                    "z_mean": None, "z_std": None, "nll_mean": None,
                    "coverage": {level: None for level in COVERAGE_LEVELS},
                    "pit": [0] * PIT_BINS,
                }
            else:
                z_mean = self._z_sum / n
                z2 = self._z2_sum / n
                totals = {
                    "z_mean": z_mean,
                    "z_std": math.sqrt(max(z2 - z_mean * z_mean, 0.0)),
                    "nll_mean": self._nll_sum / n,
                    "coverage": {
                        level: self._cov[level] / n
                        for level in COVERAGE_LEVELS
                    },
                    "pit": [int(c) for c in self._pit],
                }
            return {
                "observations": n,
                "window": self.window,
                "windows_closed": self.windows_closed,
                "consecutive_breaches": self._consecutive_breaches,
                "alert": self.alert,
                "alert_reasons": list(self.alert_reasons),
                "recent_windows": [dict(v) for v in self._recent],
                **totals,
            }


# --------------------------------------------------------------------------
# covariate summary + drift monitor
# --------------------------------------------------------------------------


def summarize_covariates(
    x,
    active=None,
    sample: int = 4096,
    seed: int = 0,
) -> Optional[dict]:
    """Compact, JSON-serializable summary of the training covariates —
    what serve needs to score incoming rows for input drift, stamped
    into the saved model's ``provenance_json``:

    * per-dim moments (mean/std/min/max over the training rows);
    * an **active-set distance sketch** — quantiles (q50/q90/q99/max) of
      the standardized euclidean distance from (a bounded sample of)
      training rows to the active set's centroid, in per-dim-std units —
      the scale-free "how far from the data mass" yardstick the drift
      scorer compares serve traffic against.

    Returns None for degenerate inputs (no rows / no finite variance).
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 2 or x.shape[0] < 2:
        return None
    finite = np.all(np.isfinite(x), axis=1)
    x = x[finite]
    if x.shape[0] < 2:
        return None
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    if not np.all(np.isfinite(std)):
        return None
    std_safe = np.where(std > 0.0, std, 1.0)
    if active is not None:
        centroid = np.asarray(active, dtype=np.float64).mean(axis=0)
    else:
        centroid = mean
    if x.shape[0] > sample:
        rng = np.random.default_rng(seed)
        rows = x[rng.choice(x.shape[0], size=sample, replace=False)]
    else:
        rows = x
    zc = (centroid - mean) / std_safe
    zr = (rows - mean) / std_safe
    dist = np.sqrt(np.mean((zr - zc) ** 2, axis=1))
    q50, q90, q99 = np.quantile(dist, (0.5, 0.9, 0.99))
    return {
        "version": COVARIATE_SUMMARY_VERSION,
        "n": int(x.shape[0]),
        "dims": int(x.shape[1]),
        "mean": [float(v) for v in mean],
        "std": [float(v) for v in std],
        "min": [float(v) for v in x.min(axis=0)],
        "max": [float(v) for v in x.max(axis=0)],
        "active_centroid": [float(v) for v in centroid],
        "active_dist": {
            "q50": float(q50),
            "q90": float(q90),
            "q99": float(q99),
            "max": float(dist.max()),
        },
    }


class DriftMonitor:
    """Scores serve-time covariate rows against a fit-time summary.

    Two scale-free breach tests per window (effect sizes, not p-values —
    with thousands of rows a p-value trips on shifts too small to
    matter):

    * **mean shift** — the window's per-dim mean must stay within
      ``shift_bar`` training standard deviations of the training mean
      (the largest dim decides);
    * **out-of-mass fraction** — the fraction of rows whose standardized
      active-centroid distance exceeds the training q99 must stay under
      ``oor_frac_bar`` (a healthy window sits near 1%).

    Same multi-window verdict semantics as :class:`QualityMonitor`.

    The per-dispatch cost is BOUNDED: a batch larger than
    ``max_rows_per_batch`` (default 16) is stride-sampled down to it
    before scoring — drift is a question about means and tail
    fractions, so a uniform subsample answers it while keeping the
    serve hot path's worst case O(16·p) regardless of batch size.
    Windows count SCORED rows.
    """

    def __init__(
        self,
        summary: dict,
        window: int = 64,
        breach_windows: int = 2,
        history: int = 16,
        shift_bar: float = 0.5,
        oor_frac_bar: float = 0.3,
        max_rows_per_batch: Optional[int] = 16,
    ) -> None:
        if window < 8:
            raise ValueError("window must be >= 8 rows")
        self.summary = summary
        self.window = int(window)
        self.breach_windows = int(breach_windows)
        self.shift_bar = float(shift_bar)
        self.oor_frac_bar = float(oor_frac_bar)
        self.max_rows_per_batch = (
            None if max_rows_per_batch is None else int(max_rows_per_batch)
        )
        self._mean = np.asarray(summary["mean"], dtype=np.float64)
        std = np.asarray(summary["std"], dtype=np.float64)
        self._std = np.where(std > 0.0, std, 1.0)
        self._inv_std = 1.0 / self._std
        self._centroid_z = (
            np.asarray(summary["active_centroid"], dtype=np.float64)
            - self._mean
        ) * self._inv_std
        # fused standardization: (x - mean)/std - centroid_z
        #                       = x * _scale - _offset  (two ops, not three)
        self._scale = self._inv_std
        self._offset = self._mean * self._inv_std + self._centroid_z
        self._dist_q99 = float(summary["active_dist"]["q99"])
        # squared threshold: the hot path compares mean squared distance
        # without paying a sqrt per batch
        self._dist_q99_sq = self._dist_q99 * self._dist_q99
        self._lock = threading.Lock()
        self.rows = 0
        self._win_n = 0
        self._win_sum = np.zeros_like(self._mean)
        self._win_oor = 0
        self._recent: deque = deque(maxlen=max(history, breach_windows))
        self._consecutive_breaches = 0
        self.windows_closed = 0
        self.alert = False
        self.alert_reasons: List[str] = []
        self.last_shift = 0.0
        self.last_oor_frac = 0.0

    def score_rows(self, x) -> List[dict]:
        """Fold a batch of serve rows in (stride-sampled down to
        ``max_rows_per_batch``); returns closed-window verdicts."""
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self._mean.shape[0]:
            return []
        cap = self.max_rows_per_batch
        if cap is not None and x.shape[0] > cap:
            # sample BEFORE the f64 conversion: only the scored rows pay
            x = x[:: -(-x.shape[0] // cap)][:cap]
        x = np.asarray(x, dtype=np.float64)
        diff = x * self._scale - self._offset
        diff *= diff
        oor_flags = diff.mean(axis=1) > self._dist_q99_sq
        closed: List[dict] = []
        n = x.shape[0]
        with self._lock:
            self.rows += n
            # fill windows chunk by chunk: one oversized batch must close
            # as many FULL windows as it spans, not collapse into one
            start = 0
            while start < n:
                take = min(n - start, self.window - self._win_n)
                seg = slice(start, start + take)
                self._win_n += take
                self._win_sum += x[seg].sum(axis=0)
                self._win_oor += int(oor_flags[seg].sum())
                start += take
                if self._win_n >= self.window:
                    closed.append(self._close_window_locked())
        return closed

    def _close_window_locked(self) -> dict:
        w = float(self._win_n)
        win_mean = self._win_sum / w
        shift = np.abs(win_mean - self._mean) / self._std
        max_shift = float(shift.max())
        oor_frac = self._win_oor / w
        reasons: List[str] = []
        if max_shift > self.shift_bar:
            dim = int(np.argmax(shift))
            reasons.append(
                f"mean_shift: dim {dim} moved {max_shift:.2f} train-std"
            )
        if oor_frac > self.oor_frac_bar:
            reasons.append(
                f"out_of_mass: {oor_frac:.2f} of rows past the train q99 "
                "distance"
            )
        verdict = {
            "rows": self._win_n,
            "max_shift_std": max_shift,
            "oor_frac": oor_frac,
            "breached": bool(reasons),
            "reasons": reasons,
        }
        self.windows_closed += 1
        self.last_shift = max_shift
        self.last_oor_frac = oor_frac
        self._recent.append(verdict)
        if reasons:
            self._consecutive_breaches += 1
        else:
            self._consecutive_breaches = 0
        was_alert = self.alert
        self.alert = self._consecutive_breaches >= self.breach_windows
        if self.alert:
            self.alert_reasons = reasons
        elif was_alert:
            self.alert_reasons = []
        verdict["alert"] = self.alert
        verdict["alert_changed"] = self.alert != was_alert
        self._win_n = 0
        self._win_sum = np.zeros_like(self._mean)
        self._win_oor = 0
        return verdict

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rows": self.rows,
                "window": self.window,
                "windows_closed": self.windows_closed,
                "consecutive_breaches": self._consecutive_breaches,
                "alert": self.alert,
                "alert_reasons": list(self.alert_reasons),
                "last_max_shift_std": self.last_shift,
                "last_oor_frac": self.last_oor_frac,
                "train_dist_q99": self._dist_q99,
            }


# --------------------------------------------------------------------------
# pending-prediction ring (the observe join buffer)
# --------------------------------------------------------------------------


class PendingRing:
    """Bounded ``request_id -> (μ, σ²)`` buffer with idempotent joins.

    ``put`` parks one answered request's predictive distribution;
    ``join`` pops it for grading.  Capacity is strictly enforced
    (oldest-first eviction, counted) so a client that never sends labels
    cannot grow server memory.  A bounded ring of RECENTLY JOINED ids
    distinguishes a duplicate observation (idempotent no-op — the
    fleet-client retry pattern re-sends) from a genuinely unknown id
    (:class:`UnknownRequestError`)."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._pending: "OrderedDict[str, tuple]" = OrderedDict()
        self._joined: "OrderedDict[str, None]" = OrderedDict()
        self.evicted = 0

    def put(self, request_id: str, mean, var) -> None:
        with self._lock:
            # a re-served id (hedged duplicate dispatch, client resend)
            # overwrites: one logical request, one pending entry
            self._pending[request_id] = (mean, var)
            self._pending.move_to_end(request_id)
            while len(self._pending) > self.capacity:
                self._pending.popitem(last=False)
                self.evicted += 1

    def join(self, request_id: str, expect_rows: Optional[int] = None):
        """``(mean, var)`` for the id, popping it; ``None`` for an
        already-joined id (the idempotent duplicate); raises
        :class:`UnknownRequestError` otherwise.  A non-None
        ``expect_rows`` that disagrees with the parked prediction raises
        ``ValueError`` WITHOUT consuming the entry — the client's
        corrected retry must still find a pending prediction, not an
        idempotent-duplicate no-op that silently loses the labels."""
        with self._lock:
            entry = self._pending.get(request_id)
            if entry is not None:
                if (
                    expect_rows is not None
                    and entry[0].shape[0] != int(expect_rows)
                ):
                    raise ValueError(
                        f"observation for {request_id!r} has "
                        f"{int(expect_rows)} label(s) but the prediction "
                        f"served {entry[0].shape[0]} row(s)"
                    )
                del self._pending[request_id]
                self._joined[request_id] = None
                while len(self._joined) > self.capacity:
                    self._joined.popitem(last=False)
                return entry
            if request_id in self._joined:
                return None
        raise UnknownRequestError(request_id)

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)


# --------------------------------------------------------------------------
# the serve-side plane (per-model composition + metric emission)
# --------------------------------------------------------------------------


#: live drift monitors kept per model NAME: stable + canary candidate +
#: headroom for a rollback/re-register racing in
_DRIFT_VERSIONS = 4


class _ModelQuality:
    """One served model name's quality state."""

    __slots__ = ("monitor", "drifts", "pending")

    def __init__(self, monitor, pending) -> None:
        self.monitor = monitor
        self.pending = pending
        # version -> Optional[DriftMonitor]: per VERSION, not one slot —
        # a canary rollout alternates stable/candidate dispatches of the
        # same name, and a single last-seen-version slot would rebuild
        # the monitor on every alternation, resetting the drift window
        # before it could ever close (drift alerting silently dead
        # exactly while a canary is active)
        self.drifts: "OrderedDict[object, Optional[DriftMonitor]]" = (
            OrderedDict()
        )

    def drift_for(self, version) -> Optional[DriftMonitor]:
        return self.drifts.get(version)

    def live_drifts(self) -> List[DriftMonitor]:
        return [d for d in self.drifts.values() if d is not None]


def quality_enabled_default() -> bool:
    """The plane's default gate: on unless ``GP_SERVE_QUALITY`` disables
    it (read at server construction, the lifecycle knobs' convention)."""
    import os

    return os.environ.get("GP_SERVE_QUALITY", "").strip().lower() not in (
        "0", "off", "false",
    )


class ServeQualityPlane:
    """Every served model's quality state, plus metric emission.

    The server calls three things: :meth:`note_predictions` on the
    batcher thread after each successful dispatch (park the answered
    requests' distributions, score the batch rows for drift),
    :meth:`observe` from the reader threads when delayed labels arrive
    (join + grade + verdict), and :meth:`snapshot` / :meth:`alert_reason`
    from the health verb and the canary guard.  All metric keys are
    registered in ``obs/names.py``; alert flips are span events so they
    land in the flight recorder next to the systems-health history.

    The batcher thread is the serving bottleneck (one dispatch loop,
    GIL-contended against every submitting client), so
    :meth:`note_predictions` does NO statistics there: it appends the
    batch to a bounded lock-free feed (a plain deque — GIL-atomic
    append, and deliberately NO wakeup notify: waking the drainer per
    dispatch forces a GIL handoff convoy on exactly the thread being
    protected) and a background drainer polls every ``DRAIN_INTERVAL_S``
    and does the pending-ring puts and drift scoring in one sweep.  A
    full feed drops the batch (counted) — telemetry must never apply
    backpressure to serving.  :meth:`observe` flushes the feed (with an
    explicit wake) before declaring a request_id unknown, so the
    label-after-reply race resolves correctly."""

    #: bound on batches parked for the drainer; beyond it batches are
    #: dropped (telemetry loss, never serve latency)
    FEED_CAPACITY = 512
    #: drainer poll cadence — the monitor's verdict latency floor, far
    #: under any real label delay
    DRAIN_INTERVAL_S = 0.05

    def __init__(
        self,
        metrics,
        window: int = 128,
        drift_window: int = 64,
        breach_windows: int = 2,
        pending_capacity: int = 4096,
    ) -> None:
        self.metrics = metrics
        self.window = int(window)
        self.drift_window = int(drift_window)
        self.breach_windows = int(breach_windows)
        self.pending_capacity = int(pending_capacity)
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelQuality] = {}
        self._feed: deque = deque()
        self._wake = threading.Event()
        self._busy = False
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._closed = False
        self.dropped_batches = 0

    def _state_for(self, name: str, entry=None) -> _ModelQuality:
        with self._lock:
            state = self._models.get(name)
            if state is None:
                state = self._models[name] = _ModelQuality(
                    QualityMonitor(
                        window=self.window,
                        breach_windows=self.breach_windows,
                    ),
                    PendingRing(self.pending_capacity),
                )
        if entry is not None and entry.version not in state.drifts:
            with self._lock:
                if entry.version not in state.drifts:
                    # bind a drift scorer to THIS version's fit-time
                    # covariate summary — a hot swap onto a retrained
                    # model must score against the new model's training
                    # mass, not the old.  Copy-on-write: readers
                    # (drainer scoring, health snapshots) iterate
                    # whatever dict object they grabbed, lock-free.
                    summary = getattr(entry.model, "covariate_summary", None)
                    drifts = OrderedDict(state.drifts)
                    drifts[entry.version] = (
                        None if not summary
                        else DriftMonitor(
                            summary,
                            window=self.drift_window,
                            breach_windows=self.breach_windows,
                        )
                    )
                    while len(drifts) > _DRIFT_VERSIONS:
                        drifts.popitem(last=False)
                    state.drifts = drifts
        return state

    # -- batcher-thread feed ------------------------------------------------
    def note_predictions(self, name, entry, group, rows, mean, var, x) -> None:
        """Hand one successful dispatch to the drainer thread: collect
        the ``(request_id, offset, rows)`` triples (the only per-request
        work) and enqueue the batch by reference — the batcher pays a
        short python loop plus one bounded-queue put.  ``mean``/``var``/
        ``x`` are the executor's own write-once-per-dispatch buffers, so
        handing references across threads is safe."""
        ids = []
        offset = 0
        for req, t in zip(group, rows):
            if req.request_id is not None and getattr(
                req, "observable", True
            ):
                ids.append((req.request_id, offset, t))
            offset += t
        if len(self._feed) >= self.FEED_CAPACITY:
            # racy overshoot by a few entries is fine; the bound holds
            self.dropped_batches += 1
            return
        self._feed.append((name, entry, ids, mean, var, x))
        worker = self._worker
        if worker is None or not worker.is_alive():
            self._ensure_worker()

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._closed or (
                self._worker is not None and self._worker.is_alive()
            ):
                return
            self._worker = threading.Thread(
                target=self._drain_loop, name="gp-serve-quality", daemon=True
            )
            self._worker.start()

    def _drain_loop(self) -> None:
        while not self._closed:
            self._wake.wait(self.DRAIN_INTERVAL_S)
            self._wake.clear()
            self._busy = True
            try:
                while True:
                    try:
                        item = self._feed.popleft()
                    except IndexError:
                        break
                    try:
                        self._process(*item)
                    except Exception:  # noqa: BLE001 — telemetry must never die
                        import logging

                        logging.getLogger("spark_gp_tpu_torch").warning(
                            "quality drainer failed on a batch", exc_info=True
                        )
            finally:
                self._busy = False

    def _process(self, name, entry, ids, mean, var, x) -> None:
        """One dispatched batch's quality work (drainer thread): park the
        id-carrying requests' distributions, score the rows for drift."""
        state = self._state_for(name, entry)
        if ids and var is not None:
            # ONE vectorized f64 conversion; each parked entry COPIES its
            # slice — a view would pin the whole dispatch's buffers alive
            # for as long as one 1-row entry stays pending (a 4096-deep
            # ring of 1-row views into 1024-row batches retains ~1000x
            # the useful bytes)
            mean64 = np.asarray(mean, dtype=np.float64)
            var64 = np.asarray(var, dtype=np.float64)
            for request_id, offset, t in ids:
                state.pending.put(
                    request_id,
                    mean64[offset : offset + t].copy(),
                    var64[offset : offset + t].copy(),
                )
            self.metrics.set_gauge(
                f"quality.pending_depth.{name}", float(state.pending.depth())
            )
        drift = None if entry is None else state.drift_for(entry.version)
        if drift is not None:
            for verdict in drift.score_rows(x):
                self._emit_drift_window(name, state, verdict)

    def flush(self, timeout_s: float = 2.0) -> bool:
        """Wait until every parked batch has been processed (bounded).
        The observe path calls this before declaring an id unknown, so
        a label arriving right behind its reply cannot lose the race
        against the drainer.  Wakes the drainer explicitly — the one
        place an immediate drain is worth a GIL handoff."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self._feed and not self._busy:
                return True
            if not self._closed and (
                self._worker is None or not self._worker.is_alive()
            ):
                self._ensure_worker()  # a died worker must not wedge this
            self._wake.set()
            time.sleep(0.002)
        return False

    def close(self) -> None:
        """Stop the drainer (server stop/drain); idempotent.  Batches
        still parked are dropped — shutdown telemetry loss, never a
        shutdown hang."""
        with self._worker_lock:
            self._closed = True
            worker = self._worker
        self._wake.set()
        if worker is not None:
            worker.join(timeout=2.0)

    # -- label joins ----------------------------------------------------------
    def observe(self, name: str, request_id: str, y, entry=None) -> dict:
        """Join delayed labels to the parked prediction and grade it.

        ``y`` is the ground-truth vector for the request's rows (scalar
        accepted for 1-row requests).  Idempotent per ``request_id``:
        the duplicate of an already-joined observation is a counted
        no-op.  Raises :class:`UnknownRequestError` when no prediction
        is pending."""
        state = self._state_for(name, entry)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        # length is checked INSIDE the join (against the parked entry,
        # without consuming it): a mismatched observation must leave the
        # prediction pending so the client's corrected retry still grades
        expect = int(y.shape[0])
        try:
            joined = state.pending.join(str(request_id), expect_rows=expect)
        except UnknownRequestError:
            # the prediction's batch may still sit in the drainer feed
            # (a label arriving right behind its reply): flush once and
            # retry before declaring the id unknown
            self.flush()
            try:
                joined = state.pending.join(
                    str(request_id), expect_rows=expect
                )
            except UnknownRequestError:
                self.metrics.inc("quality.observe.unknown_request")
                raise
        if joined is None:
            self.metrics.inc("quality.observe.duplicate")
            return {
                "model": name, "request_id": str(request_id),
                "joined": 0, "duplicate": True,
            }
        mean, var = joined
        self.metrics.inc("quality.observations", float(y.shape[0]))
        for verdict in state.monitor.observe(mean, var, y):
            self._emit_quality_window(name, state, verdict)
        self._set_quality_gauges(name, state)
        return {
            "model": name, "request_id": str(request_id),
            "joined": int(y.shape[0]), "duplicate": False,
            "alert": state.monitor.alert,
        }

    # -- metric emission -----------------------------------------------------
    def _set_quality_gauges(self, name: str, state: _ModelQuality) -> None:
        snap = state.monitor.snapshot()
        if snap["observations"] == 0:
            return
        self.metrics.set_gauge(f"quality.z_mean.{name}", snap["z_mean"])
        self.metrics.set_gauge(f"quality.z_std.{name}", snap["z_std"])
        self.metrics.set_gauge(f"quality.nll_mean.{name}", snap["nll_mean"])
        for level, value in snap["coverage"].items():
            if value is not None:
                # concatenation (not an f-string) keeps the linter from
                # wildcarding BOTH parts; the concrete keys match the
                # registered quality.coverage_<level>.* patterns
                self.metrics.set_gauge(
                    "quality.coverage_" + level + "." + name, value
                )

    def _emit_quality_window(self, name, state, verdict: dict) -> None:
        from spark_gp_tpu_torch.obs import trace as obs_trace

        self.metrics.inc("quality.windows")
        if verdict["alert_changed"]:
            self.metrics.set_gauge(
                f"quality.alert.{name}", 1.0 if verdict["alert"] else 0.0
            )
            if verdict["alert"]:
                self.metrics.inc("quality.alerts")
                obs_trace.add_event(
                    "quality.alert", model=name,
                    reasons="; ".join(verdict["reasons"]),
                )
            else:
                obs_trace.add_event("quality.recovered", model=name)

    def _emit_drift_window(self, name, state, verdict: dict) -> None:
        from spark_gp_tpu_torch.obs import trace as obs_trace

        self.metrics.inc("drift.windows")
        self.metrics.set_gauge(
            f"drift.score.{name}", verdict["max_shift_std"]
        )
        if verdict["alert_changed"]:
            self.metrics.set_gauge(
                f"drift.alert.{name}", 1.0 if verdict["alert"] else 0.0
            )
            if verdict["alert"]:
                self.metrics.inc("drift.alerts")
                obs_trace.add_event(
                    "drift.alert", model=name,
                    reasons="; ".join(verdict["reasons"]),
                )
            else:
                obs_trace.add_event("drift.recovered", model=name)

    # -- verdict consumers -----------------------------------------------------
    def alert_reason(self, name: str) -> Optional[str]:
        """One-line active-alert description for ``name`` (the canary
        guard's input), or None when healthy/unknown."""
        with self._lock:
            state = self._models.get(name)
        if state is None:
            return None
        if state.monitor.alert:
            return "miscalibration: " + "; ".join(state.monitor.alert_reasons)
        for drift in state.live_drifts():
            if drift.alert:
                return "input drift: " + "; ".join(drift.alert_reasons)
        return None

    def alerting_models(self) -> List[str]:
        with self._lock:
            names = list(self._models)
        return sorted(n for n in names if self.alert_reason(n) is not None)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._models.items())
        models = {}
        for name, state in items:
            # surface ONE drift snapshot per name: an alerting monitor
            # wins (the health payload must show the problem), else the
            # most recently bound version's
            drifts = state.live_drifts()
            drift = next(
                (d for d in drifts if d.alert),
                drifts[-1] if drifts else None,
            )
            models[name] = {
                "calibration": state.monitor.snapshot(),
                "drift": (
                    None if drift is None else drift.snapshot()
                ),
                "pending": {
                    "depth": state.pending.depth(),
                    "capacity": state.pending.capacity,
                    "evicted": state.pending.evicted,
                },
            }
        return {
            "enabled": True,
            "window": self.window,
            "breach_windows": self.breach_windows,
            "dropped_batches": self.dropped_batches,
            "alerting": self.alerting_models(),
            "models": models,
        }
