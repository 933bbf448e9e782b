"""Cost attribution: metered flops and bytes per entry point (the port's
counterpart of the JAX package's ``obs/cost.py``).

The JAX package reads XLA's ``cost_analysis()`` and ``memory_analysis()``
of each compiled entry point once per operand signature and accumulates
them per execution.  The card has no compiler cost model, so the port
counts the work itself, in two parts:

* **library operations** -- the first execution of an (entry function,
  operand signature) pair is the real call, run under a
  ``TorchDispatchMode`` counter (:class:`_LibraryCounter`) that prices
  every ATen operation it sees by the table below.  The result is cached
  (FIFO, :data:`_CACHE_MAX` signatures) and every later execution adds
  ``weight`` x the cached cost;
* **the hand-written kernels** -- every wrapper reports its kernel's work
  model (``work()`` beside each kernel: ``ops/spd_linalg.py``,
  ``ops/streamed_matvec.py``, ``ops/slq_quadrature.py``,
  ``ops/lane_gram.py``) at every launch, from the launch's shapes
  (``ops/cuda_lib.record_launch``; a captured graph's launches with each
  replay, ``count_replays``).  A wrapper's plain branch reports the same
  work and pauses the library counter over its body, so the CPU and the
  card count the same work for the same call, and a redesigned kernel
  counts what the old one did.  Kernel work is live, not cached: a
  Laplace evaluation whose Newton loop runs on the host launches K1 a
  data-dependent number of times, and each launch is counted.

The table (``m x k`` by ``k x n`` products; ``n x n`` factors; ``k``
right-hand sides; a batch multiplies each):

==============================================  ==========================
operation                                       flops
==============================================  ==========================
``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...    ``2 m n k``
``mv``, ``addmv``, ``dot``, ``vdot``            ``2 m k``
Cholesky (``linalg_cholesky_ex``)               ``n^3 / 3``
triangular solve                                ``n^2 k``
``cholesky_solve``                              ``2 n^2 k`` (two solves)
``cholesky_inverse``                            ``2 n^3 / 3``
views and allocations                           0 (and no bytes)
copies and fills                                0
every other operation (elementwise, reductions) one per element of its
                                                largest operand
==============================================  ==========================

Bytes are each operation's tensor inputs read once and its outputs
written once.  The peak: while metering is on and the call runs on the
card outside a graph capture, the first execution's peak is
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``,
less the allocation at entry (a memory sample of the active fit capture
is taken just before the reset, so the fit's recorded peak survives it);
it is relayed to ``resilience/memplan.note_compiled_peak``.

Attribution follows the JAX package: the counters ``xla.flops.<entry>``
and ``xla.bytes.<entry>`` (``gp_xla_flops_total{entry=...}``), where
``entry`` is the active trace root (``fit.GaussianProcessRegression``,
``serve.batch``) or the call site's fallback label (``predict.ppa``,
``fit.host_objective``, ``fit.device``), and the active fit capture's
per-entry table, from which the run journal's ``xla_cost`` block is
built (``obs/runtime.py``).  For a captured CUDA graph (the device
optimizer's step, a serve bucket) the cost of one execution is counted
at capture and each replay is an execution.

Metering is off by default: ``GP_XLA_COST=1`` (or
:func:`set_cost_metering`) turns it on, and it is always off while
tracing is off.  It changes no result and no launch count: the counter
only reads shapes, and a metered execution runs its backward on the
calling thread (``torch.autograd.set_multithreading_enabled(False)``) so
the counter and the kernels' reports see it.  A failing measurement
counts ``xla.cost_failures`` and the call's result stands.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import subprocess
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger("spark_gp_tpu_torch")

_forced: Optional[bool] = None

_CACHE: Dict[Tuple, Dict[str, float]] = {}
_LOCK = threading.Lock()
#: signature-cache bound, FIFO: far above any steady-state count of
#: entry signatures; an evicted signature is measured again
_CACHE_MAX = 512
#: ids of the entry functions whose death evicts their cache entries
_WATCHED: Dict[int, Any] = {}

_STATE = threading.local()


def cost_metering_enabled() -> bool:
    """The gate, read at call time: :func:`set_cost_metering` wins, else
    ``GP_XLA_COST`` (default off); always off while tracing is off."""
    from spark_gp_tpu_torch.obs import trace as obs_trace

    if not obs_trace.tracing_enabled():
        return False
    if _forced is not None:
        return _forced
    return os.environ.get("GP_XLA_COST", "").strip().lower() in ("1", "on", "true")


def set_cost_metering(enabled: Optional[bool]) -> None:
    """Force cost metering on or off for this process (None: the env)."""
    global _forced
    _forced = enabled


def clear_cache() -> None:
    """Drop the signature cache."""
    with _LOCK:
        _CACHE.clear()


def _sig_of(value: Any):
    """Hashable signature of one operand: tensors and arrays by (shape,
    dtype), containers structurally, scalars by value, other objects by
    type and identity."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        return ("a", tuple(shape), str(dtype))
    if isinstance(value, dict):
        return ("d", tuple((k, _sig_of(v)) for k, v in sorted(value.items())))
    if isinstance(value, (tuple, list)):
        return ("t", tuple(_sig_of(v) for v in value))
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return ("o", type(value).__name__, id(value))


def _evict(fn_id: int) -> None:
    with _LOCK:
        _WATCHED.pop(fn_id, None)
        for key in [k for k in _CACHE if k[0] == fn_id]:
            del _CACHE[key]


def _key(fn, args: tuple, kwargs: dict) -> Tuple:
    """The cache key of one call: the entry function's identity and the
    operands' signature.  A function's entries go with it, so a reused
    ``id`` never finds a dead function's cost."""
    fn_id = id(fn)
    with _LOCK:
        watched = fn_id in _WATCHED
    if not watched:
        try:
            finalizer = weakref.finalize(fn, _evict, fn_id)
        except TypeError:  # no weak reference: the entry lives on
            finalizer = None
        with _LOCK:
            _WATCHED[fn_id] = finalizer
    return (fn_id, _sig_of(args), _sig_of(tuple(sorted(kwargs.items()))))


def _cached(key: Tuple) -> Optional[Dict[str, float]]:
    with _LOCK:
        return _CACHE.get(key)


def _store(key: Tuple, cost: Dict[str, float]) -> None:
    with _LOCK:
        while len(_CACHE) >= _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = cost


# -- the library-operation counter --------------------------------------------


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@functools.lru_cache(maxsize=None)
def _table():
    """``{overload packet: flops(args, outs)}`` and the zero-flop sets."""
    import torch

    aten = torch.ops.aten

    def mm(args, outs):
        a, b = args[0], args[1]
        return 2.0 * _numel(a.shape[:-1]) * a.shape[-1] * b.shape[-1]

    def addmm(args, outs):
        return mm(args[1:], outs)

    def mv(args, outs):
        return 2.0 * args[0].numel()

    def addmv(args, outs):
        return 2.0 * args[1].numel()

    def chol(args, outs):
        a = args[0]
        return _numel(a.shape[:-2]) * a.shape[-1] ** 3 / 3.0

    def tri_solve(args, outs):
        a, b = args[0], args[1]  # linalg_solve_triangular(A, B)
        return _numel(b.shape[:-2]) * a.shape[-1] ** 2 * b.shape[-1]

    def tri_solve_legacy(args, outs):
        b, a = args[0], args[1]  # triangular_solve(B, A)
        return _numel(b.shape[:-2]) * a.shape[-1] ** 2 * b.shape[-1]

    def chol_solve(args, outs):
        b, l_ = args[0], args[1]
        return 2.0 * _numel(b.shape[:-2]) * l_.shape[-1] ** 2 * b.shape[-1]

    def chol_inv(args, outs):
        a = args[0]
        return _numel(a.shape[:-2]) * 2.0 * a.shape[-1] ** 3 / 3.0

    flops = {
        aten.mm: mm, aten.bmm: mm,
        aten.addmm: addmm, aten.baddbmm: addmm, aten.addbmm: addmm,
        aten.mv: mv, aten.dot: mv, aten.vdot: mv, aten.addmv: addmv,
        aten.linalg_cholesky_ex: chol, aten.cholesky: chol,
        aten.linalg_solve_triangular: tri_solve, aten.triangular_solve: tri_solve_legacy,
        aten.cholesky_solve: chol_solve, aten.cholesky_inverse: chol_inv,
    }
    free = {
        aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
        aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
        aten._local_scalar_dense, aten.set_, aten.resize_,
    }
    moves = {
        aten.copy_, aten._to_copy, aten.clone, aten._copy_from, aten.zeros, aten.ones,
        aten.full, aten.zeros_like, aten.ones_like, aten.full_like, aten.fill_, aten.zero_,
        aten.arange, aten.eye, aten.scalar_tensor, aten.new_zeros, aten.new_ones,
        aten.new_full, aten.cat, aten.stack, aten.index_select, aten.gather,
    }
    return flops, free, moves


def _op_cost(func, args, kwargs, out) -> Tuple[float, float]:
    """``(flops, bytes)`` of one ATen operation (module table)."""
    flops_of, free, moves = _table()
    packet = func.overloadpacket
    if func.is_view or packet in free:
        return 0.0, 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    nbytes = float(sum(t.numel() * t.element_size() for t in ins)
                   + sum(t.numel() * t.element_size() for t in outs))
    if packet in moves:
        return 0.0, nbytes
    fn = flops_of.get(packet)
    if fn is not None:
        return float(fn(args, outs)), nbytes
    return float(max([t.numel() for t in ins + outs], default=0)), nbytes


@functools.lru_cache(maxsize=None)
def _library_counter_type():
    """The dispatch counter's class, built at first use (the CPU test
    harness imports this module without ever metering)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _LibraryCounter(TorchDispatchMode):
        """Prices every ATen operation it sees (module table), unless a
        kernel wrapper has paused it."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.paused = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not self.paused:
                flops, nbytes = _op_cost(func, args, kwargs, out)
                self.flops += flops
                self.bytes += nbytes
            return out

    # the first operation a dispatch mode sees imports torch._dynamo (1.5 s
    # and more): paid here, on a CPU scalar, and never inside a graph capture
    with _LibraryCounter():
        torch.zeros(())
    return _LibraryCounter


@contextlib.contextmanager
def library_paused():
    """Around a kernel wrapper's body: the library counter of this thread
    (if one is measuring) counts none of the wrapper's own operations;
    the wrapper reports its kernel's work instead."""
    counter = getattr(_STATE, "counter", None)
    if counter is None:
        yield
        return
    counter.paused += 1
    try:
        yield
    finally:
        counter.paused -= 1


# -- the live kernel sink ----------------------------------------------------


class _Execution:
    """The kernels' work reported during one metered execution (or batch
    of replays): ``{kernel: [launches, flops, bytes]}``."""

    __slots__ = ("kernels",)

    def __init__(self):
        self.kernels: Dict[str, list] = {}

    def add(self, name: str, launches: float, flops: float, nbytes: float) -> None:
        row = self.kernels.setdefault(name, [0.0, 0.0, 0.0])
        row[0] += launches
        row[1] += flops
        row[2] += nbytes


def note_kernel(name: str, work, launches: float = 1.0) -> None:
    """One launch (or the plain version's run) of kernel ``name`` doing
    ``work = (flops, bytes)`` in all over ``launches`` launches, into the
    metered execution open on this thread (a no-op outside one, or for a
    launch with no work model)."""
    ex = getattr(_STATE, "execution", None)
    if ex is not None and work is not None:
        ex.add(name, float(launches), float(work[0]), float(work[1]))


@contextlib.contextmanager
def _execution():
    import torch

    prev = getattr(_STATE, "execution", None)
    ex = _Execution()
    _STATE.execution = ex
    try:
        # the backward on this thread: the counter and the sink are
        # this thread's
        with torch.autograd.set_multithreading_enabled(False):
            yield ex
    finally:
        _STATE.execution = prev


def _card_peak_possible() -> bool:
    import torch

    return (torch.cuda.is_available() and torch.cuda.is_initialized()
            and not torch.cuda.is_current_stream_capturing())


class _Measurement:
    """One measured execution: :meth:`start` installs a fresh library
    counter on this thread (and, on the card outside a capture, resets
    the peak reads); :meth:`stop` removes it and returns the cost."""

    def __init__(self):
        self.counter = _library_counter_type()()
        self.peak_base = None
        self.prev = None

    def start(self) -> None:
        import torch

        from spark_gp_tpu_torch.obs import runtime as obs_runtime

        if _card_peak_possible():
            obs_runtime.sample_capture_memory("cost.measure")
            torch.cuda.reset_peak_memory_stats()
            self.peak_base = torch.cuda.memory_allocated()
        self.prev = getattr(_STATE, "counter", None)
        _STATE.counter = self.counter
        self.counter.__enter__()

    def stop(self, ok: bool = True) -> Optional[Dict[str, float]]:
        import torch

        self.counter.__exit__(None, None, None)
        _STATE.counter = self.prev
        if not ok:
            return None
        cost = {"flops": self.counter.flops, "bytes": self.counter.bytes}
        if self.peak_base is not None:
            torch.cuda.synchronize()
            peak = float(torch.cuda.max_memory_allocated() - self.peak_base)
            if peak > 0:
                cost["peak_bytes"] = peak
        return cost


@contextlib.contextmanager
def _measured(sink: dict):
    """Run the block as a measured execution; its cost lands in
    ``sink["cost"]`` (absent when counting failed, which never fails the
    block; a block that raises is not counted)."""
    meter = _Measurement()
    try:
        meter.start()
    except Exception as exc:  # noqa: BLE001 -- metering never fails the call
        _failed(exc)
        yield
        return
    try:
        yield
    except BaseException:
        meter.stop(ok=False)
        raise
    try:
        sink["cost"] = meter.stop()
    except Exception as exc:  # noqa: BLE001
        _failed(exc)


# -- attribution -------------------------------------------------------------


def _attribute(entry_fallback: str, cost: Dict[str, float], weight: float,
               kernels: Dict[str, list]) -> None:
    from spark_gp_tpu_torch.obs import runtime as obs_runtime
    from spark_gp_tpu_torch.obs import trace as obs_trace

    entry = obs_trace.current_root_name() or entry_fallback
    flops = cost["flops"] * weight + sum(k[1] for k in kernels.values())
    nbytes = cost["bytes"] * weight + sum(k[2] for k in kernels.values())
    obs_runtime.telemetry.inc(f"xla.flops.{entry}", entry=entry, n=flops)
    obs_runtime.telemetry.inc(f"xla.bytes.{entry}", entry=entry, n=nbytes)
    obs_runtime.note_xla_cost(entry, cost, weight, kernels)
    if cost.get("peak_bytes"):
        from spark_gp_tpu_torch.resilience import memplan

        memplan.note_compiled_peak(entry, cost["peak_bytes"])


def _failed(exc: BaseException) -> None:
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc("xla.cost_failures")
    logger.warning("cost metering skipped a signature: %s: %s", type(exc).__name__, exc)


def measure(fn, args: tuple, kwargs: Optional[dict] = None):
    """``(out, cost)``: run ``fn(*args, **kwargs)`` under the library
    counter (the first execution of a signature) and cache the cost;
    ``cost`` is ``{"flops", "bytes"}`` of the library operations (and
    ``"peak_bytes"`` on the card), or None when counting failed."""
    kwargs = kwargs or {}
    sink: dict = {}
    with _measured(sink):
        out = fn(*args, **kwargs)
    cost = sink.get("cost")
    if cost is not None:
        _store(_key(fn, args, kwargs), cost)
    return out, cost


def observed_call(entry_fallback: str, fn, *args, **kwargs):
    """Meter and invoke in one step: returns ``fn(*args, **kwargs)`` and,
    when metering is on, attributes one execution (the library cost of
    its signature, measured on this first call or taken from the cache,
    and the kernels' work it launched).  The call runs first: a call
    that raises is not counted."""
    if not cost_metering_enabled():
        return fn(*args, **kwargs)
    with _execution() as ex:
        cost = _cached(_key(fn, args, kwargs))
        if cost is None:
            out, cost = measure(fn, args, kwargs)
        else:
            out = fn(*args, **kwargs)
    if cost is not None:
        _attribute(entry_fallback, cost, 1.0, ex.kernels)
    return out


class ReplayMeter:
    """Metering of a CUDA graph (or an eager step standing for one):
    :meth:`capturing` around the capture counts one execution's library
    operations (the kernels it launches are tallied with their work,
    ``ops/cuda_lib.capture_tally``); :meth:`replays` around replays (or
    eager steps) attributes ``n`` executions and the kernels' work that
    ``count_replays`` (or the eager launches) report.  :meth:`initial`
    around the loop's initial evaluation, which runs eagerly before the
    first step, meters it as one more execution: its kernels' work, and on
    the card its own peak, the one per-execution peak a captured loop
    has (a capture cannot read one), relayed to the memory planner as a
    host evaluation's is.  It is attributed at the step's per-execution
    cost once the step is metered, so the fit keeps one journal row (the
    JAX package meters its whole loop as one program), and at its own
    cost by :meth:`finish` where no step ran.  Every method is a plain
    pass-through when metering is off."""

    def __init__(self, entry_fallback: str):
        self.entry_fallback = entry_fallback
        self.cost: Optional[Dict[str, float]] = None
        #: the initial evaluation's ``(cost, kernels)``, until attributed
        self._initial = None

    @contextlib.contextmanager
    def initial(self):
        """The loop's initial evaluation, metered as one execution (class
        doc)."""
        if not cost_metering_enabled():
            yield
            return
        sink: dict = {}
        with _execution() as ex:
            with _measured(sink):
                yield
        if sink.get("cost") is not None:
            self._initial = (sink["cost"], ex.kernels)

    def _flush_initial(self, cost: Optional[Dict[str, float]] = None) -> None:
        if self._initial is None:
            return
        own, kernels = self._initial
        self._initial = None
        at = dict(own if cost is None else cost)
        peaks = [c.get("peak_bytes") or 0.0 for c in (own, at)]
        at.pop("peak_bytes", None)
        if max(peaks) > 0:
            at["peak_bytes"] = max(peaks)
        _attribute(self.entry_fallback, at, 1.0, kernels)

    def finish(self) -> None:
        """At the loop's end: an initial evaluation no step followed is
        attributed at its own cost."""
        self._flush_initial()

    @contextlib.contextmanager
    def capturing(self):
        if not cost_metering_enabled():
            yield
            return
        sink: dict = {}
        with _measured(sink):
            yield
        if sink.get("cost") is not None:
            self.cost = sink["cost"]

    @contextlib.contextmanager
    def replays(self, n: float):
        """``n`` executions happen in the block (replays, or eager steps
        whose first one this meter measures when nothing was captured)."""
        if not cost_metering_enabled():
            yield
            return
        with _execution() as ex:
            yield
        if self.cost is not None:
            _attribute(self.entry_fallback, self.cost, float(n), ex.kernels)
            self._flush_initial(self.cost)

    @contextlib.contextmanager
    def eager_step(self):
        """One eager execution: the first is measured, later ones take
        its cost."""
        if not cost_metering_enabled():
            yield
            return
        with self.replays(1.0):
            if self.cost is None:
                with self.capturing():
                    yield
            else:
                yield


def measured_flops(entry: str) -> float:
    """Total metered flops attributed to ``entry`` so far (the
    ``gp_xla_flops_total{entry=}`` series, read on the host)."""
    from spark_gp_tpu_torch.obs.runtime import telemetry

    return telemetry.snapshot()["counters"].get(f"xla.flops.{entry}", 0.0)


@functools.lru_cache(maxsize=8)
def power_limit(index: int = 0) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it (``700.00 W``),
    or None where it cannot be read."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=10, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    text = proc.stdout.strip()
    return text or None


def mfu_against_peak(flops_total: float, seconds: float,
                     lane: str = "strict") -> Optional[Dict[str, Any]]:
    """Metered flops over ``seconds`` against the card's peak for the
    arithmetic the optimize phase runs: float32 outside the tensor cores
    on the ``strict`` lane, TF32 tensor cores on ``mixed`` and ``fast``
    (``ops/precision.chip_peaks``).  None on the CPU (no device figure
    is reported for a CPU run, unlike the JAX package's proxy), for an
    unknown card, or a degenerate denominator."""
    if not flops_total or not seconds or seconds <= 0.0:
        return None
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    from spark_gp_tpu_torch.ops.precision import chip_peaks

    index = torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    peaks = chip_peaks(name)
    if peaks is None:
        return None
    if lane == "strict":
        peak, peak_name = peaks.f32, "float32 (no tensor cores)"
    else:
        peak, peak_name = peaks.tf32, "tf32 tensor cores (dense)"
    if not peak:
        return None
    return {
        "device_kind": name,
        "peak": peak_name,
        "peak_tflops": peak / 1e12,
        "power_limit": power_limit(index),
        "achieved_tflops": flops_total / seconds / 1e12,
        "mfu": flops_total / seconds / peak,
    }
