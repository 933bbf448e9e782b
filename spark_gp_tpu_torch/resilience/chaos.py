"""Deterministic fault injection for the fit and predict paths (the port's
copy of the JAX package's ``resilience/chaos.py``, fit and predict half).

Every fault is seed- or count-driven, so the tests that stage them are
ordinary deterministic tests:

* :func:`poison_expert` -- corrupt the raw rows round-robin grouping
  assigns to one expert (NaN / inf / huge / duplicated rows), bit for bit
  the JAX package's rows;
* :func:`failing_cholesky` -- the host jitter ladder's factorization
  fails for its first N attempts (``ops/linalg.py``), driving the ladder
  and, with a large N, ``NotPositiveDefiniteException``;
* :func:`oom_after_calls` / :func:`failing_compile` -- execution faults
  for the degradation ladder (``resilience/fallback.py``), raised at the
  choke points (:func:`maybe_injected_failure`: ``fit.host`` before the
  host optimizer, ``predict.chunk`` before each predict dispatch,
  ``ppa.magic_solve`` before the device magic solve, where an allocator
  failure on its ``[m, m]`` buffers would surface).  An
  injected OOM is a genuine ``torch.cuda.OutOfMemoryError`` in the
  caching allocator's wording, so the classifier and every ``except``
  clause see what a real allocator failure looks like.  Env channel:
  ``GP_CHAOS_OOM_AFTER_CALLS`` (+ ``GP_CHAOS_OOM_OP``,
  ``GP_CHAOS_OOM_ROWS_ABOVE``) and ``GP_CHAOS_FAILING_COMPILE`` (+
  ``GP_CHAOS_COMPILE_OP``);
* :func:`memory_limit_bytes` -- a shrunken device budget of ``n`` bytes:
  the memory planner (``resilience/memplan.py``) reads it as its budget,
  and a choke point whose modeled byte cost exceeds it raises the OOM.
  Env channel: ``GP_CHAOS_MEMORY_LIMIT_BYTES``.

* :func:`miscalibrate` / :func:`drift_inputs` -- statistical-quality
  faults on the serve path: the served variance scaled by ``scale**2``
  (:func:`sigma_scale`), every admitted request's features shifted
  (:func:`input_shift`); the quality plane (``obs/quality.py``) must
  alert.  Env channels: ``GP_CHAOS_MISCALIBRATE``,
  ``GP_CHAOS_DRIFT_INPUTS``;

* :class:`PreemptingCheckpointer` / :func:`preempt_after_saves` -- a
  deterministic preemption right after the k-th checkpoint save
  (:class:`SimulatedPreemption`): the atomic save leaves the complete
  k-th state on disk, and a refit resumes from it;
* :class:`FlakyPredictor` / :func:`break_model` -- a serving predict that
  fails or stalls on schedule (circuit breaker, poisoned-batch isolation);
* :class:`HangingPredictor` / :func:`hang_model` -- a serving predict that
  blocks until released (the wedged device the hang watchdog is for).

* :func:`corrupt_device` -- one rank's redundant diagonal-panel copies
  inside the sharded Cholesky (``ops/dist_linalg.py``) scaled: the silent
  corruption the panel tripwire (``resilience/integrity.py``) is for.
  Env channel: ``GP_CHAOS_CORRUPT_DEVICE`` (+ ``GP_CHAOS_CORRUPT_SCALE``).

* the mesh faults, consumed at the coordination plane's choke points
  (``parallel/coord.py``): :func:`StragglerHost` (every guarded step
  entered late; ``GP_CHAOS_STRAGGLER_S`` + ``GP_CHAOS_STRAGGLER_OP``),
  :func:`DeadHost` (die before the next guarded step and stop
  heartbeating; ``GP_CHAOS_DEAD_HOST=1`` exits the process),
  ``GP_CHAOS_NO_HEARTBEAT=1`` (stamps suppressed),
  :func:`stage_preemption` (an in-process SIGTERM for the preemption
  watcher), :func:`kill_process_after` (``os._exit`` after N save
  boundaries; ``GP_CHAOS_KILL_AFTER_ITERS``) and :func:`corrupt_host`
  (one rank publishes corrupted store payloads: ``bitflip``, ``stuck`` or
  ``scale``; ``GP_CHAOS_CORRUPT_PID`` + ``GP_CHAOS_CORRUPT_KIND`` /
  ``_OP`` / ``_SCALE``), which the attested collectives
  (``resilience/integrity.py``) must refuse and attribute.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import numpy as np
import torch


def poison_expert(
    x: np.ndarray,
    y: np.ndarray,
    expert: int,
    num_experts: int,
    kind: str = "nan",
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Corrupt every row that round-robin grouping assigns to ``expert``
    (``parallel/experts.py``: expert ``j`` takes rows ``j, j+E, ...``).
    ``kind``: ``"nan"`` (a NaN feature per row, columns from
    ``default_rng(seed)``), ``"inf"`` (an infinite label), ``"huge"``
    (features scaled by 1e300), ``"dup"`` (every row a copy of the first:
    an exactly singular gram).  Returns corrupted copies."""
    if not 0 <= expert < num_experts:
        raise ValueError(f"expert {expert} out of range [0, {num_experts})")
    x = np.array(x, dtype=np.float64, copy=True)
    y = np.array(y, dtype=np.float64, copy=True)
    rows = np.arange(expert, x.shape[0], num_experts)
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, x.shape[1], size=rows.shape[0])
    if kind == "nan":
        x[rows, cols] = np.nan
    elif kind == "inf":
        y[rows] = np.inf
    elif kind == "huge":
        x[rows] *= 1e300
    elif kind == "dup":
        x[rows] = x[rows[0]]
        y[rows] = y[rows[0]]
    else:
        raise ValueError(f"unknown poison kind {kind!r}")
    return x, y


@contextlib.contextmanager
def failing_cholesky(times: int = 1):
    """The host jitter ladder's factorization attempt
    (``ops.linalg._jittered_cholesky``) returns an all-NaN factor -- the
    port's failed-factorization signal -- for its first ``times`` calls.
    Yields a one-element list counting the injected failures."""
    from spark_gp_tpu_torch.ops import linalg

    original = linalg._jittered_cholesky
    fired = [0]

    def chaotic(mat, tau):
        if fired[0] < times:
            fired[0] += 1
            return torch.full_like(mat, float("nan"))
        return original(mat, tau)

    linalg._jittered_cholesky = chaotic
    try:
        yield fired
    finally:
        linalg._jittered_cholesky = original


#: in-process staged faults; the env vars are the subprocess channel
_state = {
    "oom_after": None,       # int | None: matching calls allowed before OOM
    "oom_op": None,          # substring filter | None
    "oom_rows_above": None,  # int | None: only dispatches above this size
    "oom_calls": 0,          # matching calls observed so far
    "oom_fired": None,       # one-element list: injected-OOM count
    "compile_fail": None,    # int | None: remaining injected compile failures
    "compile_op": None,      # substring filter | None
    "compile_fired": None,   # one-element list: injected-failure count
    "memory_limit": None,    # float | None: staged device memory budget
    "memory_fired": None,    # one-element list: budget-OOM count
    "sigma_scale": None,     # float | None: staged served-sigma factor
    "input_shift": None,     # float | None: staged covariate shift
    "corrupt_device": None,  # int | None: the rank whose panel copies go wrong
    "corrupt_scale": None,   # float | None: the factor they are scaled by
    "straggler_s": None,     # float | None: delay before a guarded step
    "straggler_op": None,    # substring filter | None
    "dead_host": False,      # True -> die before the next guarded step
    "dead_exit": True,       # os._exit vs SimulatedPreemption
    "no_heartbeat": False,   # True -> suppress heartbeat stamps
    "kill_after": None,      # int | None: save boundaries left before os._exit
    "preempt": False,        # True -> coord.preemption_requested()
    "corrupt_pid": None,     # int | None: the rank whose payloads go wrong
    "corrupt_kind": None,    # "bitflip" | "stuck" | "scale" | None
    "corrupt_op": None,      # substring filter | None
    "corrupt_fired": None,   # one-element list: corruption count
    "corrupt_prev": None,    # {(pid, base_op): last sealed blob} (stuck)
}

#: the exit code of a staged dead rank or kill (a SIGKILLed process's)
PREEMPTION_EXIT_CODE = 137


def _env_chaos_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def staged_memory_limit() -> Optional[float]:
    """The staged memory budget in bytes, or None: the in-process stage
    (:func:`memory_limit_bytes`) wins, else ``GP_CHAOS_MEMORY_LIMIT_BYTES``.
    Read by the memory planner as its budget AND by the choke points'
    allocator model, so the two never disagree about the ceiling."""
    staged = _state["memory_limit"]
    if staged is not None:
        return float(staged)
    return _env_chaos_float("GP_CHAOS_MEMORY_LIMIT_BYTES")


def _oom(message: str) -> torch.cuda.OutOfMemoryError:
    """A genuine allocator OOM, worded like the caching allocator's."""
    return torch.cuda.OutOfMemoryError(f"CUDA out of memory. {message}")


def maybe_injected_failure(op: str, rows: Optional[int] = None,
                           nbytes: Optional[float] = None) -> None:
    """The execution-failure trigger point, called before the work it
    names (``fit.host``, ``predict.chunk``, ``ppa.magic_solve``, the
    device fits' ``fit.device.*``):

    * **memory budget** (:func:`memory_limit_bytes`): work whose modeled
      byte cost ``nbytes`` exceeds the staged limit raises the OOM;
      callers passing no ``nbytes`` never trip it;
    * **OOM** (:func:`oom_after_calls`): after ``n`` matching calls every
      further matching call raises it; ``op`` substring and
      ``rows_above`` filters scope the fault;
    * **compile failure** (:func:`failing_compile`): the next ``times``
      matching calls raise a compilation-shaped ``RuntimeError``.
    """
    if nbytes is not None:
        limit = staged_memory_limit()
        if limit is not None and float(nbytes) > limit:
            fired = _state["memory_fired"]
            if fired is not None:
                fired[0] += 1
            raise _oom(f"chaos: attempting to allocate {int(nbytes)} bytes over the "
                       f"{int(limit)}-byte staged device budget at {op!r}")
    allow, op_filter, rows_above = (_state["oom_after"], _state["oom_op"],
                                    _state["oom_rows_above"])
    if allow is None:
        env = os.environ.get("GP_CHAOS_OOM_AFTER_CALLS", "").strip()
        if env:
            try:
                allow = int(env)
            except ValueError:
                allow = None
            op_filter = os.environ.get("GP_CHAOS_OOM_OP", "") or None
            raw_rows = os.environ.get("GP_CHAOS_OOM_ROWS_ABOVE", "").strip()
            rows_above = int(raw_rows) if raw_rows.isdigit() else None
    if allow is not None and (not op_filter or op_filter in op):
        if rows_above is None or (rows is not None and rows > rows_above):
            _state["oom_calls"] += 1
            if _state["oom_calls"] > allow:
                fired = _state["oom_fired"]
                if fired is not None:
                    fired[0] += 1
                raise _oom(f"chaos: injected device OOM at {op!r} (call {_state['oom_calls']})")
    remaining, c_filter = _state["compile_fail"], _state["compile_op"]
    if remaining is None:
        env = os.environ.get("GP_CHAOS_FAILING_COMPILE", "").strip()
        if env:
            try:
                remaining = int(env)
            except ValueError:
                remaining = None
            if remaining is not None:
                _state["compile_fail"] = remaining
            c_filter = os.environ.get("GP_CHAOS_COMPILE_OP", "") or None
            _state["compile_op"] = c_filter
    if remaining and (not c_filter or c_filter in op):
        _state["compile_fail"] = remaining - 1
        fired = _state["compile_fired"]
        if fired is not None:
            fired[0] += 1
        raise RuntimeError(f"INTERNAL: during compilation: chaos: injected "
                           f"compilation failure at {op!r}")


@contextlib.contextmanager
def oom_after_calls(n: int, op: Optional[str] = None, rows_above: Optional[int] = None):
    """Stage an injected OOM: the first ``n`` matching calls succeed, every
    later one raises (see :func:`maybe_injected_failure`).  Yields a
    one-element list counting the injections."""
    if int(n) < 0:
        raise ValueError("n must be >= 0")
    keys = ("oom_after", "oom_op", "oom_rows_above", "oom_calls", "oom_fired")
    prev = {k: _state[k] for k in keys}
    fired = [0]
    _state.update(oom_after=int(n), oom_op=op,
                  oom_rows_above=None if rows_above is None else int(rows_above),
                  oom_calls=0, oom_fired=fired)
    try:
        yield fired
    finally:
        _state.update(prev)


@contextlib.contextmanager
def memory_limit_bytes(n: float):
    """Stage a device memory budget of ``n`` bytes (planner budget and
    choke-point allocator model).  Yields the one-element injected-OOM
    counter."""
    if float(n) <= 0:
        raise ValueError("memory limit must be > 0 bytes")
    prev = (_state["memory_limit"], _state["memory_fired"])
    fired = [0]
    _state.update(memory_limit=float(n), memory_fired=fired)
    try:
        yield fired
    finally:
        _state["memory_limit"], _state["memory_fired"] = prev


@contextlib.contextmanager
def failing_compile(times: int = 1, op: Optional[str] = None):
    """Stage injected compilation failures for the next ``times`` matching
    calls, then clean.  Yields the injected-failure counter."""
    if int(times) < 1:
        raise ValueError("times must be >= 1")
    keys = ("compile_fail", "compile_op", "compile_fired")
    prev = {k: _state[k] for k in keys}
    fired = [0]
    _state.update(compile_fail=int(times), compile_op=op, compile_fired=fired)
    try:
        yield fired
    finally:
        _state.update(prev)


# --- statistical-quality faults (obs/quality.py reads them on the serve path)


def sigma_scale() -> Optional[float]:
    """The staged served-sigma miscalibration factor, or None: the
    in-process stage (:func:`miscalibrate`) wins, else
    ``GP_CHAOS_MISCALIBRATE``.  The serve executor scales the served
    variance by ``scale**2`` after a successful predict, modeling a model
    whose sigma is ``scale`` times wrong (``scale < 1``: overconfident)."""
    staged = _state["sigma_scale"]
    if staged is not None:
        return float(staged)
    return _env_chaos_float("GP_CHAOS_MISCALIBRATE")


def input_shift() -> Optional[float]:
    """The staged additive covariate shift, or None: the in-process stage
    (:func:`drift_inputs`) wins, else ``GP_CHAOS_DRIFT_INPUTS``.  The serve
    submit path shifts every admitted request's features by it, modeling
    upstream feature drift the fit never saw."""
    staged = _state["input_shift"]
    if staged is not None:
        return float(staged)
    return _env_chaos_float("GP_CHAOS_DRIFT_INPUTS")


@contextlib.contextmanager
def miscalibrate(scale: float):
    """Stage a served-sigma miscalibration: every serve answer's variance
    is scaled by ``scale**2`` (``0.5``: the classic 2x sigma shrink).  The
    quality monitor must raise ``quality.alert.*`` within a bounded number
    of graded observations.  Subprocess channel: ``GP_CHAOS_MISCALIBRATE``."""
    if float(scale) <= 0:
        raise ValueError("sigma scale must be > 0")
    prev = _state["sigma_scale"]
    _state["sigma_scale"] = float(scale)
    try:
        yield
    finally:
        _state["sigma_scale"] = prev


@contextlib.contextmanager
def drift_inputs(shift: float):
    """Stage an additive covariate shift on every admitted serve request:
    the drift monitor must raise ``drift.alert.*`` within a bounded number
    of rows while a clean run never does.  Subprocess channel:
    ``GP_CHAOS_DRIFT_INPUTS``."""
    prev = _state["input_shift"]
    _state["input_shift"] = float(shift)
    try:
        yield
    finally:
        _state["input_shift"] = prev


# --- preemption (checkpoint/resume) --------------------------------------


class SimulatedPreemption(BaseException):
    """In-process preemption marker (a ``BaseException``: ``except
    Exception`` recovery code must not swallow a kill).  Raised out of a
    fit, it carries ``nfev``, the objective evaluations the fit ran."""


class PreemptingCheckpointer:
    """The host optimizer's checkpoint callback
    (``utils/checkpoint.LbfgsCheckpointer``) or the device optimizer's
    segment saver, killed right after its k-th save by
    :class:`SimulatedPreemption`.  The wrapped write is atomic, so
    the file on disk is the complete k-th state and a refit resumes from
    it."""

    def __init__(self, inner, kill_after_saves: int) -> None:
        if kill_after_saves < 1:
            raise ValueError("kill_after_saves must be >= 1")
        self.inner = inner
        self.kill_after_saves = int(kill_after_saves)
        self.saves = 0

    def __call__(self, theta) -> None:
        self.inner(theta)
        self.saves += 1
        if self.saves >= self.kill_after_saves:
            raise SimulatedPreemption(f"preempted after checkpoint save #{self.saves}")

    def record(self, theta, value, grad) -> None:
        self.inner.record(theta, value, grad)

    def save(self, state, meta: dict) -> None:
        """The device optimizer's segment save (``utils/checkpoint.
        DeviceOptimizerCheckpointer``), killed the same way."""
        self.inner.save(state, meta)
        self.saves += 1
        if self.saves >= self.kill_after_saves:
            raise SimulatedPreemption(f"preempted after checkpoint save #{self.saves}")

    def load(self, template, meta: dict):
        return self.inner.load(template, meta)

    @property
    def iteration(self):
        return self.inner.iteration

    @iteration.setter
    def iteration(self, value) -> None:
        self.inner.iteration = value


_preempt = {"after": None, "last": None}


@contextlib.contextmanager
def preempt_after_saves(k: int):
    """Stage a preemption: every checkpointer a fit makes inside the block
    (``setCheckpointDir``) is wrapped in a :class:`PreemptingCheckpointer`
    that kills after ``k`` saves.  Yields a one-element list holding the
    last wrapper made."""
    prev = dict(_preempt)
    made = [None]
    _preempt.update(after=int(k), last=made)
    try:
        yield made
    finally:
        _preempt.update(prev)


def maybe_preempting(checkpointer):
    """``checkpointer`` behind the staged preemption, if one is staged."""
    if _preempt["after"] is None:
        return checkpointer
    wrapped = PreemptingCheckpointer(checkpointer, _preempt["after"])
    _preempt["last"][0] = wrapped
    return wrapped


# --- serving faults -------------------------------------------------------


class FlakyPredictor:
    """A serving predict that fails or stalls on a deterministic schedule,
    standing in for ``serve/batcher.BucketedPredictor`` (everything else
    delegates to the wrapped predictor): the first ``fail_first`` predicts
    raise ``exc_type``, every one with ``fail_forever``; ``latency_s``
    sleeps before answering."""

    def __init__(self, inner, fail_first: int = 0, fail_forever: bool = False,
                 latency_s: float = 0.0, exc_type: type = RuntimeError) -> None:
        self._inner = inner
        self.fail_first = int(fail_first)
        self.fail_forever = bool(fail_forever)
        self.latency_s = float(latency_s)
        self.exc_type = exc_type
        self.calls = 0

    def predict(self, x, *args, **kwargs):
        self.calls += 1
        if self.latency_s:
            time.sleep(self.latency_s)
        if self.fail_forever or self.calls <= self.fail_first:
            raise self.exc_type(f"chaos: injected predict failure (call {self.calls})")
        return self._inner.predict(x, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class HangingPredictor:
    """A serving predict that blocks: the first ``hang_first`` predicts
    (every one with ``hang_forever``) wait on an event until
    :meth:`release`, so a test trips the hang watchdog and then unwinds
    the wedged thread; ``max_block_s`` bounds a forgotten release."""

    def __init__(self, inner, hang_first: int = 0, hang_forever: bool = False,
                 max_block_s: float = 60.0) -> None:
        self._inner = inner
        self.hang_first = int(hang_first)
        self.hang_forever = bool(hang_forever)
        self.max_block_s = float(max_block_s)
        self._release = threading.Event()
        #: set when a predict starts to hang (a test waits on it)
        self.entered = threading.Event()
        self.calls = 0
        self.hung = 0

    def predict(self, x, *args, **kwargs):
        self.calls += 1
        if self.hang_forever or self.calls <= self.hang_first:
            self.hung += 1
            self.entered.set()
            self._release.wait(self.max_block_s)
        return self._inner.predict(x, *args, **kwargs)

    def release(self) -> None:
        """Unblock every parked (and every later would-hang) predict."""
        self._release.set()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def hang_model(server, name: str, version: Optional[int] = None, **hang_kw):
    """Swap a registered model's predictor for a :class:`HangingPredictor`;
    returns it (call ``release()`` in teardown)."""
    entry = server.registry.get(name, version)
    hanging = HangingPredictor(entry.predictor, **hang_kw)
    entry.predictor = hanging
    return hanging


def break_model(server, name: str, version: Optional[int] = None, **flaky_kw):
    """Swap a registered model's predictor for a :class:`FlakyPredictor`;
    returns it (its ``calls`` count is the evidence the fault fired)."""
    entry = server.registry.get(name, version)
    flaky = FlakyPredictor(entry.predictor, **flaky_kw)
    entry.predictor = flaky
    return flaky


def staged_device_corruption() -> Optional[tuple]:
    """``(rank, scale)`` when a sharded-solve fault is staged
    (:func:`corrupt_device`, else ``GP_CHAOS_CORRUPT_DEVICE`` with
    ``GP_CHAOS_CORRUPT_SCALE``, default 1e3), else None: read by
    ``ops/dist_linalg.sharded_cholesky``."""
    rank, scale = _state["corrupt_device"], _state["corrupt_scale"]
    if rank is None:
        env_rank = _env_chaos_float("GP_CHAOS_CORRUPT_DEVICE")
        if env_rank is None:
            return None
        rank, scale = int(env_rank), _env_chaos_float("GP_CHAOS_CORRUPT_SCALE")
    return int(rank), float(scale if scale else 1e3)


@contextlib.contextmanager
def corrupt_device(index: int, scale: float = 1e3):
    """Scale rank ``index``'s redundantly computed diagonal panel copies
    inside the sharded blocked Cholesky by ``scale``: the cross-rank
    divergence the integrity plane's panel tripwire exists to catch."""
    prev = (_state["corrupt_device"], _state["corrupt_scale"])
    _state["corrupt_device"], _state["corrupt_scale"] = int(index), float(scale)
    try:
        yield
    finally:
        _state["corrupt_device"], _state["corrupt_scale"] = prev


# --- mesh faults (parallel/coord.py consumes them at its choke points) --------


def apply_straggler_delay(op: str) -> float:
    """Sleep the staged straggler delay before the named coordination step
    (when the op filter matches); returns the seconds slept.  Staged by
    :func:`StragglerHost`, or ``GP_CHAOS_STRAGGLER_S`` (+ the substring
    filter ``GP_CHAOS_STRAGGLER_OP``) in a subprocess."""
    delay, op_filter = _state["straggler_s"], _state["straggler_op"]
    if delay is None:
        delay = _env_chaos_float("GP_CHAOS_STRAGGLER_S")
        op_filter = os.environ.get("GP_CHAOS_STRAGGLER_OP", "") or None
    if not delay or (op_filter and op_filter not in op):
        return 0.0
    time.sleep(delay)
    return delay


def maybe_die_before_collective(op: str) -> None:
    """The dead-rank trigger: guarded steps call this first, so a staged
    dead rank exits (or raises :class:`SimulatedPreemption`) BEFORE a call
    its peers would wait on."""
    if _state["dead_host"] or os.environ.get("GP_CHAOS_DEAD_HOST", "") == "1":
        if _state["dead_host"] and not _state["dead_exit"]:
            raise SimulatedPreemption(f"chaos: DeadHost died before collective {op!r}")
        os._exit(PREEMPTION_EXIT_CODE)


def heartbeats_suppressed() -> bool:
    return (_state["no_heartbeat"] or _state["dead_host"]
            or os.environ.get("GP_CHAOS_NO_HEARTBEAT", "") == "1"
            or os.environ.get("GP_CHAOS_DEAD_HOST", "") == "1")


def preemption_staged() -> bool:
    """The in-process stand-in for a delivered SIGTERM
    (:func:`stage_preemption`)."""
    return bool(_state["preempt"])


def stage_preemption(on: bool = True) -> None:
    _state["preempt"] = bool(on)


@contextlib.contextmanager
def StragglerHost(delay_s: float, op: Optional[str] = None):
    """Make THIS process a straggler: every guarded step (only those whose
    name contains ``op``, when given) is entered ``delay_s`` late."""
    prev = (_state["straggler_s"], _state["straggler_op"])
    _state["straggler_s"], _state["straggler_op"] = float(delay_s), op
    try:
        yield
    finally:
        _state["straggler_s"], _state["straggler_op"] = prev


@contextlib.contextmanager
def DeadHost(exit_process: bool = False):
    """Make THIS process die before its next guarded step and stop
    heartbeating at once: ``exit_process=True`` exits with
    ``os._exit(137)`` (subprocesses); the default raises
    :class:`SimulatedPreemption` at the step."""
    prev = (_state["dead_host"], _state["dead_exit"])
    _state["dead_host"], _state["dead_exit"] = True, bool(exit_process)
    try:
        yield
    finally:
        _state["dead_host"], _state["dead_exit"] = prev


def kill_process_after(n_iters: int) -> None:
    """Stage ``os._exit(137)`` after ``n_iters`` more save boundaries
    (:func:`tick_kill_counter`, called at each by ``utils/checkpoint.py``
    and the coordinated checkpointers); ``GP_CHAOS_KILL_AFTER_ITERS=<n>``
    in a subprocess."""
    if int(n_iters) < 1:
        raise ValueError("n_iters must be >= 1")
    _state["kill_after"] = int(n_iters)


def tick_kill_counter() -> None:
    remaining = _state["kill_after"]
    if remaining is None:
        raw = os.environ.get("GP_CHAOS_KILL_AFTER_ITERS", "").strip()
        if not raw:
            return
        try:
            remaining = int(raw)
        except ValueError:
            return
    remaining -= 1
    _state["kill_after"] = remaining
    if remaining <= 0:
        os._exit(PREEMPTION_EXIT_CODE)


def _corrupt_staged(op: str, pid) -> Optional[tuple]:
    """``(kind, scale, fired)`` when the staged corruption targets this
    (op, rank), else None.  Scoped by rank because the protocol tests run
    every logical rank as a thread of one process."""
    cpid, kind = _state["corrupt_pid"], _state["corrupt_kind"]
    op_filter, scale, fired = _state["corrupt_op"], _state["corrupt_scale"], \
        _state["corrupt_fired"]
    if cpid is None:
        env_pid = _env_chaos_float("GP_CHAOS_CORRUPT_PID")
        if env_pid is None:
            return None
        cpid = int(env_pid)
        kind = os.environ.get("GP_CHAOS_CORRUPT_KIND", "").strip() or "bitflip"
        op_filter = os.environ.get("GP_CHAOS_CORRUPT_OP", "").strip() or None
        scale = _env_chaos_float("GP_CHAOS_CORRUPT_SCALE")
    if int(pid) != int(cpid) or (op_filter and op_filter not in op):
        return None
    return kind, float(scale if scale else 1e3), fired


def maybe_corrupt_published(op: str, pid, blob: bytes) -> bytes:
    """The byte-level corruption point: ``coord.kv_allgather`` passes every
    payload through here AFTER sealing, right before the store.
    ``bitflip`` flips one bit of the payload; ``stuck`` republishes this
    (rank, op)'s previous round's blob (the first matching round publishes
    honestly to have something to replay).  ``scale`` is a value fault
    (:func:`maybe_corrupt_arrays`)."""
    staged = _corrupt_staged(op, pid)
    if staged is None:
        return blob
    kind, _, fired = staged
    if kind == "bitflip" and blob:
        if fired is not None:
            fired[0] += 1
        return blob[:-1] + bytes([blob[-1] ^ 0x01])
    if kind == "stuck":
        prev_map = _state["corrupt_prev"]
        if prev_map is None:
            prev_map = _state["corrupt_prev"] = {}
        key = (int(pid), op.split("/")[0])
        prev = prev_map.get(key)
        prev_map[key] = blob
        if prev is not None and prev != blob:
            if fired is not None:
                fired[0] += 1
            return prev
    return blob


def maybe_corrupt_arrays(op: str, pid, arrays):
    """The value-level corruption point: the store mode's array gathers pass
    this rank's contribution through here before packing; ``scale``
    multiplies every float array by the staged factor (a rank whose
    COMPUTE is silently wrong: its bytes are consistent, so only the
    magnitude bar or a spot check catches it)."""
    staged = _corrupt_staged(op, pid)
    if staged is None or staged[0] != "scale":
        return arrays
    _, scale, fired = staged
    out, changed = [], False
    for a in arrays:
        a = np.asarray(a)
        if a.size and np.issubdtype(a.dtype, np.floating):
            out.append((a * scale).astype(a.dtype))
            changed = True
        else:
            out.append(a)
    if changed and fired is not None:
        fired[0] += 1
    return out


@contextlib.contextmanager
def corrupt_host(pid: int, kind: str = "bitflip", op: Optional[str] = None,
                 scale: float = 1e3):
    """Make rank ``pid`` publish corrupted store payloads (``kind`` one of
    bitflip, stuck, scale; only collectives whose name contains ``op``,
    when given).  Yields a one-element fired-count list."""
    if kind not in ("bitflip", "stuck", "scale"):
        raise ValueError(f"unknown corruption kind {kind!r}")
    keys = ("corrupt_pid", "corrupt_kind", "corrupt_op", "corrupt_scale", "corrupt_fired",
            "corrupt_prev")
    prev = {k: _state[k] for k in keys}
    fired = [0]
    _state.update(corrupt_pid=int(pid), corrupt_kind=kind, corrupt_op=op,
                  corrupt_scale=float(scale), corrupt_fired=fired, corrupt_prev={})
    try:
        yield fired
    finally:
        _state.update(prev)
