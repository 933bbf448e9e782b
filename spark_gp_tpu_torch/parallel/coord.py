"""Deadline-guarded coordination: every cross-process interaction outside
the algorithm's own sums routes through here (the JAX package's
``parallel/coord.py``).

The fit's algorithmic collectives -- the (NLL, grad) sum, the (U1, u2)
sum -- are the mesh's (``parallel/mesh.py``).  Everything else a
multi-process fit needs -- agreeing on stack dims, electing a checkpoint
writer, noticing that a peer died -- is process coordination, and a raw
process-group call has no deadline of its own short of the group's
timeout and no name for the rank that never came: one slow, preempted or
dead rank turned a fit into a hang.

The process group is brought up over a ``torch.distributed.Store``
(``parallel/distributed.initialize``: a ``FileStore`` for ``file://``, a
``TCPStore`` hosted by rank 0 for ``tcp://`` and ``env://``), and this
module puts its protocols on that store, under the ``coord`` prefix so
its keys never meet the group's own.  The store plays the part of the JAX
coordination service's key-value store.  This module and
``parallel/distributed.py`` are the only ones that touch a store or a
process-group barrier (``tests/test_torch_coord.py`` lints the rest of
the package).  It provides:

* a **key-value client** over the store (:class:`KVStoreClient`) plus an
  in-process fake with an injectable clock (:class:`InProcessCoordClient`)
  so every protocol here is testable without real processes;
* **deadline-guarded barriers** (:func:`guard_collective`, :func:`barrier`)
  and :func:`kv_allgather` / :meth:`DcnContext.allreduce_arrays` that
  raise :class:`CoordinationTimeoutError` *naming the missing ranks*
  instead of hanging;
* a **heartbeat/liveness registry** (:class:`HeartbeatMonitor`): each
  process stamps ``heartbeat/<rank>``; stragglers and dead ranks become
  span events and ``coord.*`` metrics; an EXPLICIT dead verdict handed to
  a gather aborts the wait early, while the passive monitor's own flags
  stay advisory (heartbeats are rightly quiet during long local compute
  -- the deadline is the arbiter).  The monitor is driven from the
  coordination waits (``maybe_poll``); the threaded ``start()`` is for
  the in-process fake only;
* **coordinated checkpointing** (:class:`CoordinatedLbfgsCheckpointer`,
  :class:`CoordinatedDeviceCheckpointer`): the ranks agree on the save
  step, rank 0 writes (the atomic writers of ``utils/checkpoint.py``),
  every rank cross-checks the payload digest through the store -- a
  divergent rank is an error, not a silently different checkpoint;
* **elastic-resume metadata** (:func:`elastic_meta`): checkpoints carry
  ``(process_count, mesh_shape, expert_assignment)`` so a P-rank fit can
  resume on P' ranks -- theta is replicated, only the expert stack
  re-shards;
* the **key-value-store fit mode** (:class:`DcnContext`): each rank fits
  its own block and the small aggregates -- each evaluation's (NLL, grad),
  the (U1, u2) statistics, the sampled active rows, the class count --
  are summed over the store in rank order, bit-identically on every rank,
  with no process-group collective in the fit.  Every payload is sealed
  and checked (``resilience/integrity.py``).  The mode is the JAX
  package's DCN fallback; where the JAX package enters it when its
  backend cannot run one program across processes, a process group's
  collectives always cross processes, so here ``GP_DCN_MODE=1`` asks for
  it (:func:`dcn_required`).
* **preemption** (:func:`preemption_watch`, :class:`PreemptedError`):
  SIGTERM sets a flag that the next save boundary acts on, on every rank
  together.

Timeout defaults (seconds, env-overridable): ``GP_COORD_TIMEOUT_S`` (120)
for barriers and gathers, ``GP_COORD_HEARTBEAT_S`` (5) for the stamp
interval; a peer is a *straggler* past 3 intervals without a fresh stamp
and *dead* past 10 (``GP_COORD_DEAD_AFTER_S`` overrides the latter).
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CoordinationTimeoutError",
    "DcnContext",
    "HeartbeatMonitor",
    "LivenessLedger",
    "InProcessCoordClient",
    "InProcessCoordStore",
    "KVStoreClient",
    "CoordinatedLbfgsCheckpointer",
    "CoordinatedDeviceCheckpointer",
    "PreemptedError",
    "barrier",
    "coord_client",
    "dcn_context",
    "elastic_meta",
    "guard_collective",
    "kv_allgather",
    "liveness_snapshot",
    "install_preemption_watcher",
    "make_flag_handler",
    "preemption_requested",
    "store_mesh",
]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_timeout_s() -> float:
    """The one deadline every guarded coordination step defaults to."""
    return _env_float("GP_COORD_TIMEOUT_S", 120.0)


def heartbeat_interval_s() -> float:
    return _env_float("GP_COORD_HEARTBEAT_S", 5.0)


class CoordinationTimeoutError(RuntimeError):
    """A cross-process coordination step blew its deadline.

    Carries the operation name, the deadline and ``missing``: the ranks
    that never showed up."""

    def __init__(self, op: str, timeout_s: float, missing: Sequence[int],
                 detail: str = "") -> None:
        self.op = op
        self.timeout_s = float(timeout_s)
        self.missing = tuple(int(p) for p in missing)
        who = (f"missing process id(s) {list(self.missing)}" if self.missing
               else "missing process set unknown")
        super().__init__(f"coordination step {op!r} timed out after {timeout_s:.1f}s: {who}"
                         + (f" ({detail})" if detail else ""))


def _bump(key: str, n: float = 1.0) -> None:
    """``coord.*`` metrics ride the process-global runtime telemetry, so they
    land in OpenMetrics pages and run journals."""
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc(key, n=n)  # metric-name-ok (concrete key from the caller)


def _event(name: str, **attrs) -> None:
    from spark_gp_tpu_torch.obs import trace as obs_trace

    obs_trace.add_event(name, **attrs)  # metric-name-ok (concrete name from the caller)


# --------------------------------------------------------------------------
# clients
# --------------------------------------------------------------------------


class AgentErrorSignal(RuntimeError):
    """The store itself failed (not a plain deadline): with a ``TCPStore``,
    its host -- rank 0 -- is gone.  Carries the error text, which names the
    implicated rank (``task:0``), so the caller can name it without
    another call on the store."""

    def __init__(self, message: str) -> None:
        self.message = message
        super().__init__(message)


def _tasks_named_in_error(message: str) -> List[int]:
    """The ranks an error text implicates (``task:1``)."""
    return sorted({int(m) for m in re.findall(r"task[:_](\d+)", message)})


def _gc_own_attendance(client, history: List[Tuple[str, ...]], new_keys: Tuple[str, ...]) -> None:
    """Attendance-key cleanup shared by both clients' ``barrier``: record
    this barrier's keys and delete those of the barrier TWO before -- every
    peer has passed barrier k-1 before this rank can enter barrier k
    (barriers are strictly sequential a process), so nobody still reads
    the k-2 keys.  Without this a long coordinated fit leaks keys a barrier
    into the store for its lifetime."""
    history.append(tuple(new_keys))
    if len(history) > 2:
        for key in history.pop(0):
            client.delete(key)


class KVStoreClient:
    """The process group's ``torch.distributed.Store`` (under the ``coord``
    prefix) behind the one interface every protocol here is written
    against: ``set`` / ``get`` / ``try_get`` / ``check`` / ``delete`` move
    small ``bytes`` payloads, ``barrier`` is attendance keys plus a
    counter.  A store has no blocking get with a deadline that both store
    kinds keep (``FileStore.wait`` overshoots short timeouts by most of a
    second), so ``get`` polls ``check`` with a short backoff, in slices of
    at most 0.5 s, and a deadline or a death verdict can end a wait early.
    """

    _CHUNK_S = 0.5
    _POLL_MIN_S = 0.0001
    _POLL_MAX_S = 0.004

    def __init__(self, store, process_id: int, num_processes: int,
                 host_rank: Optional[int] = None) -> None:
        self._store = store
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        #: the rank that hosts the store (a ``TCPStore``'s rank 0), named
        #: when the store stops answering; None for a ``FileStore``
        self.host_rank = host_rank
        self.clock = time.monotonic
        self.sleep = time.sleep
        # one store call in flight a process: a heartbeat thread and the
        # fit thread may share this client
        self._lock = threading.Lock()
        self._att_history: List[Tuple[str, ...]] = []

    def _call(self, fn, *args):
        try:
            with self._lock:
                return fn(*args)
        except Exception as exc:  # noqa: BLE001 -- any store failure is named
            who = "" if self.host_rank is None else f" (its host, task:{self.host_rank})"
            raise AgentErrorSignal(f"coordination store failed{who}: {exc}") from exc

    def set(self, key: str, value: bytes) -> None:
        self._call(self._store.set, key, bytes(value))

    def check(self, key: str) -> bool:
        return bool(self._call(self._store.check, [key]))

    def try_get(self, key: str) -> Optional[bytes]:
        """The value now, or None without waiting."""
        return bytes(self._call(self._store.get, key)) if self.check(key) else None

    def get(self, key: str, timeout_s: float) -> Optional[bytes]:
        """The value, or ``None`` on deadline (callers own the diagnosis);
        raises :class:`AgentErrorSignal` when the store itself fails."""
        deadline = self.clock() + max(0.0, timeout_s)
        pause = self._POLL_MIN_S
        while True:
            if self.check(key):
                return bytes(self._call(self._store.get, key))
            remaining = deadline - self.clock()
            if remaining <= 0.0:
                return None
            self.sleep(min(pause, remaining, self._CHUNK_S))
            pause = min(2.0 * pause, self._POLL_MAX_S)

    def delete(self, key: str) -> None:
        try:
            self._call(self._store.delete_key, key)
        except AgentErrorSignal:
            pass  # best-effort cleanup

    def barrier(self, name: str, timeout_s: float) -> None:
        """Attendance-stamped barrier: each rank sets
        ``barrier_att/<name>/<rank>`` and adds one to ``barrier_cnt/<name>``,
        then waits for the count to reach the world size under the
        deadline.  On expiry the attendance keys name exactly who never
        arrived; a store that fails names its host."""
        att, cnt = f"barrier_att/{name}/{self.process_id}", f"barrier_cnt/{name}"
        self.set(att, b"1")
        arrived = int(self._call(self._store.add, cnt, 1))
        _gc_own_attendance(self, self._att_history, (att, cnt))
        deadline = self.clock() + max(0.0, timeout_s)
        pause = self._POLL_MIN_S
        try:
            while arrived < self.num_processes:
                remaining = deadline - self.clock()
                if remaining <= 0.0:
                    missing = [r for r in range(self.num_processes)
                               if not self.check(f"barrier_att/{name}/{r}")]
                    raise CoordinationTimeoutError(f"barrier/{name}", timeout_s, missing)
                self.sleep(min(pause, remaining, self._CHUNK_S))
                pause = min(2.0 * pause, self._POLL_MAX_S)
                arrived = int(self._call(self._store.add, cnt, 0))
        except AgentErrorSignal as exc:
            missing = [t for t in _tasks_named_in_error(exc.message) if t != self.process_id]
            raise CoordinationTimeoutError(f"barrier/{name}", timeout_s, missing,
                                           detail=exc.message[:200]) from exc


class InProcessCoordStore:
    """The shared half of :class:`InProcessCoordClient`: one a simulated
    cluster, handed to every logical process's client."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.kv: Dict[str, bytes] = {}


class InProcessCoordClient:
    """Fake key-value client: N logical processes inside one OS process.

    The test harness for every protocol in this module -- barriers,
    gathers, heartbeats, coordinated checkpoints, elastic resume -- with no
    subprocesses and, through the injectable ``clock`` / ``sleep`` pair, no
    real waiting in timeout tests (a fake clock that advances on ``sleep``
    resolves a 120 s deadline at once)."""

    _POLL_S = 0.002

    def __init__(self, store: InProcessCoordStore, process_id: int, num_processes: int,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], None]] = None) -> None:
        self._store = store
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.clock = clock
        self.sleep = sleep if sleep is not None else time.sleep
        self._att_history: List[Tuple[str, ...]] = []

    def set(self, key: str, value: bytes) -> None:
        with self._store.cond:
            self._store.kv[key] = bytes(value)
            self._store.cond.notify_all()

    def check(self, key: str) -> bool:
        with self._store.lock:
            return key in self._store.kv

    def try_get(self, key: str) -> Optional[bytes]:
        with self._store.lock:
            return self._store.kv.get(key)

    def get(self, key: str, timeout_s: float) -> Optional[bytes]:
        deadline = self.clock() + max(0.0, timeout_s)
        while True:
            got = self.try_get(key)
            if got is not None:
                return got
            if self.clock() >= deadline:
                return None
            self.sleep(self._POLL_S)

    def dir_get(self, prefix: str) -> Dict[str, bytes]:
        with self._store.lock:
            return {k: v for k, v in self._store.kv.items() if k.startswith(prefix)}

    def delete(self, key: str) -> None:
        with self._store.lock:
            self._store.kv.pop(key, None)

    def barrier(self, name: str, timeout_s: float) -> None:
        att = f"barrier_att/{name}/{self.process_id}"
        self.set(att, b"1")
        _gc_own_attendance(self, self._att_history, (att,))
        deadline = self.clock() + max(0.0, timeout_s)
        prefix = f"barrier_att/{name}/"
        while True:
            arrived = {int(k.rsplit("/", 1)[-1]) for k in self.dir_get(prefix)}
            if len(arrived) >= self.num_processes:
                return
            if self.clock() >= deadline:
                missing = sorted(set(range(self.num_processes)) - arrived)
                raise CoordinationTimeoutError(f"barrier/{name}", timeout_s, missing)
            self.sleep(self._POLL_S)


_CLIENT_SINGLETON: Optional[KVStoreClient] = None
_CLIENT_LOCK = threading.Lock()


def coord_client() -> Optional[KVStoreClient]:
    """The live client over the group's store, or ``None`` when the group
    was not brought up by ``parallel/distributed.initialize`` (the one
    owner of the store handle).  ONE cached instance a store: it carries
    the one-call-in-flight lock and the attendance cleanup history, which
    only work if every caller shares them."""
    global _CLIENT_SINGLETON
    from spark_gp_tpu_torch.parallel import distributed

    handle = distributed.coord_store()
    if handle is None:
        return None
    store, rank, world, host_rank = handle
    with _CLIENT_LOCK:
        if _CLIENT_SINGLETON is None or _CLIENT_SINGLETON._store is not store:
            _CLIENT_SINGLETON = KVStoreClient(store, rank, world, host_rank)
    return _CLIENT_SINGLETON


def reset_runtime_state() -> None:
    """Forget the client and the contexts of a previous store (a group
    destroyed and brought up again in one process)."""
    global _CLIENT_SINGLETON, _DCN_SINGLETON, _BARE_SINGLETON, _COLLECTIVE_SEQ_N
    with _CLIENT_LOCK, _DCN_LOCK, _COLLECTIVE_SEQ_LOCK:
        _CLIENT_SINGLETON = _DCN_SINGLETON = _BARE_SINGLETON = None
        _COLLECTIVE_SEQ_N = 0


# --------------------------------------------------------------------------
# runtime ownership: the one place that brings up the process group
# --------------------------------------------------------------------------


def runtime_initialized() -> bool:
    import torch.distributed as dist

    return bool(dist.is_available() and dist.is_initialized())


def initialize_runtime(backend: str, store, world_size: int, rank: int, timeout, **kwargs) -> None:
    """``init_process_group`` over ``store``: the one call of it in the
    package (``parallel/distributed.initialize`` builds the store)."""
    import torch.distributed as dist

    dist.init_process_group(backend, store=store, world_size=int(world_size), rank=int(rank),
                            timeout=timeout, **kwargs)


_COLLECTIVE_SEQ_LOCK = threading.Lock()
_COLLECTIVE_SEQ_N = 0


def _next_collective_seq() -> int:
    """PROCESS-global barrier sequence: peers must land on the same barrier
    id for their k-th guarded collective whichever thread runs the fit."""
    global _COLLECTIVE_SEQ_N
    with _COLLECTIVE_SEQ_LOCK:
        seq = _COLLECTIVE_SEQ_N
        _COLLECTIVE_SEQ_N += 1
        return seq


def guard_collective(name: str, *, timeout_s: Optional[float] = None,
                     client: Optional[object] = None) -> None:
    """The no-hang pre-flight of a blocking cross-process step: apply any
    chaos straggler delay, die if this process is the staged dead rank,
    then meet the others at a deadline-guarded barrier, so a dead or
    wedged peer surfaces as a :class:`CoordinationTimeoutError` naming it
    before this process enters a collective it could not be interrupted
    out of.  One process (or no client): a no-op."""
    from spark_gp_tpu_torch.resilience import chaos

    chaos.apply_straggler_delay(name)
    chaos.maybe_die_before_collective(name)
    cl = client if client is not None else coord_client()
    if cl is None or cl.num_processes <= 1:
        return
    seq = _next_collective_seq()
    try:
        cl.barrier(f"collective/{name}/{seq}",
                   default_timeout_s() if timeout_s is None else timeout_s)
    except CoordinationTimeoutError:
        _bump("coord.barrier_timeouts")
        _event("coord.barrier_timeout", op=name)
        raise


def barrier(name: str, timeout_s: Optional[float] = None,
            client: Optional[object] = None) -> None:
    """Deadline-guarded named barrier (``name`` unique a use)."""
    cl = client if client is not None else coord_client()
    if cl is None or cl.num_processes <= 1:
        return
    try:
        cl.barrier(name, default_timeout_s() if timeout_s is None else timeout_s)
    except CoordinationTimeoutError:
        _bump("coord.barrier_timeouts")
        _event("coord.barrier_timeout", op=name)
        raise


# --------------------------------------------------------------------------
# allgather / allreduce over the store
# --------------------------------------------------------------------------


def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
    return buf.getvalue()


def _unpack_arrays(payload: bytes) -> List[np.ndarray]:
    with np.load(io.BytesIO(payload)) as npz:
        return [npz[f"a{i}"] for i in range(len(npz.files))]


def kv_allgather(name: str, payload: bytes, *, client: object,
                 timeout_s: Optional[float] = None,
                 dead_pids: Optional[Callable[[], Sequence[int]]] = None,
                 monitor: Optional["HeartbeatMonitor"] = None, trust=None) -> List[bytes]:
    """One small ``bytes`` payload a rank, in rank order.

    Every rank publishes ``ag/<name>/<rank>`` then reads every peer's key
    under one deadline.  On expiry -- or as soon as ``dead_pids`` (a
    liveness verdict) implicates a peer still awaited -- raises
    :class:`CoordinationTimeoutError` naming the missing ranks.  ``name``
    must be unique a round (callers sequence it).  A ``monitor`` is driven
    from this wait loop (``maybe_poll``); its verdicts are advisory, only
    ``dead_pids`` aborts a wait before its deadline.

    This is also the attestation choke point (``resilience/integrity.py``):
    every payload is sealed with a content digest, its publisher and the
    round-qualified name before publishing, and verified on read, so a
    corrupted payload raises ``AttestationError`` naming its PUBLISHER on
    every reader alike; a ``trust`` ledger takes the verdict.
    ``GP_INTEGRITY=0`` publishes raw bytes."""
    from spark_gp_tpu_torch.resilience import chaos, integrity

    # the gathers are the store mode's collectives: the staged straggler
    # delay and dead-rank exit apply here as guard_collective applies them
    chaos.apply_straggler_delay(name)
    chaos.maybe_die_before_collective(name)
    cl = client
    verify = integrity.enabled()
    payload = integrity.seal(name, cl.process_id, payload) if verify else payload
    # corruption lands AFTER sealing, right before the wire
    payload = chaos.maybe_corrupt_published(name, cl.process_id, payload)
    timeout = default_timeout_s() if timeout_s is None else timeout_s
    if monitor is not None:
        monitor.maybe_poll()

    def _fail(missing: Sequence[int], detail: str = "") -> None:
        _bump("coord.barrier_timeouts")
        _event("coord.barrier_timeout", op=f"allgather/{name}")
        raise CoordinationTimeoutError(f"allgather/{name}", timeout, missing, detail=detail)

    prefix = f"ag/{name}/"
    try:
        cl.set(f"{prefix}{cl.process_id}", payload)
    except AgentErrorSignal as exc:
        _fail([t for t in _tasks_named_in_error(exc.message) if t != cl.process_id],
              detail=exc.message[:200])
    out: List[Optional[bytes]] = [None] * cl.num_processes
    deadline = cl.clock() + timeout
    for pid in range(cl.num_processes):
        while out[pid] is None:
            remaining = deadline - cl.clock()
            if remaining <= 0.0:
                break
            try:
                got = cl.get(f"{prefix}{pid}", min(remaining, 0.5))
            except AgentErrorSignal as exc:
                named = [t for t in _tasks_named_in_error(exc.message) if t != cl.process_id]
                _fail(named or [pid], detail=exc.message[:200])
            if got is not None:
                out[pid] = got
                break
            if monitor is not None:
                monitor.maybe_poll()
            if dead_pids is not None and pid in {int(p) for p in dead_pids()}:
                break
        if out[pid] is None:
            # a plain deadline: the round's keys name who never published
            missing = [r for r in range(cl.num_processes) if not cl.check(f"{prefix}{r}")]
            _fail(missing or [pid])
    results: List[bytes] = []
    for pid, blob in enumerate(out):
        try:
            results.append(integrity.unseal(name, pid, blob, verify=verify))
        except integrity.AttestationError as exc:
            _bump("integrity.attestation_failures")
            _event("integrity.corrupt_payload", op=name, pid=pid, code=exc.code)
            if trust is not None:
                trust.record_disagreement(pid, definitive=True, reason=exc.code)
            raise
    return results


# --------------------------------------------------------------------------
# heartbeat / liveness
# --------------------------------------------------------------------------


class LivenessLedger:
    """Identity-agnostic straggler/dead escalation: the one state machine
    behind every heartbeat surface, so "straggler past 3 intervals, dead
    past 10, recovered on a fresh stamp" means the same everywhere.

    ``observe`` takes one sweep's view -- the current clock, the stamp
    counters read back, the expected identities -- and updates the flags;
    the callbacks fire OUTSIDE the lock.  A peer is *seen* when its stamp
    counter CHANGES, not when a key merely exists: a dead process's last
    stamp stays in the store."""

    def __init__(self, straggler_after_s: float, dead_after_s: float,
                 on_straggler: Optional[Callable[[object, float], None]] = None,
                 on_dead: Optional[Callable[[object, float], None]] = None,
                 on_recover: Optional[Callable[[object], None]] = None) -> None:
        self.straggler_after_s = float(straggler_after_s)
        self.dead_after_s = float(dead_after_s)
        self._on_straggler = on_straggler
        self._on_dead = on_dead
        self._on_recover = on_recover
        self._last_seen: Dict[object, Tuple[int, float]] = {}  # id -> (n, at)
        self._flagged: Dict[object, str] = {}  # id -> "straggler" | "dead"
        self._lock = threading.Lock()

    def observe(self, now: float, stamps: Dict[object, int],
                expected: Sequence[object] = (), skip: Sequence[object] = ()) -> None:
        skip_set = set(skip)
        recovered: List[object] = []
        escalated: List[Tuple[object, str, float]] = []
        with self._lock:
            # seed every expected identity at first sight: a peer that dies
            # before its first stamp would otherwise read as healthy forever
            for ident in expected:
                self._last_seen.setdefault(ident, (-1, now))
            for ident, n in stamps.items():
                prev = self._last_seen.get(ident)
                if prev is None or prev[0] != n:
                    self._last_seen[ident] = (int(n), now)
                    if ident in self._flagged:
                        del self._flagged[ident]
                        recovered.append(ident)
            for ident, (_, at) in self._last_seen.items():
                if ident in skip_set:
                    continue
                age = now - at
                state = self._flagged.get(ident)
                if age > self.dead_after_s and state != "dead":
                    self._flagged[ident] = "dead"
                    escalated.append((ident, "dead", age))
                elif self.dead_after_s >= age > self.straggler_after_s and state is None:
                    self._flagged[ident] = "straggler"
                    escalated.append((ident, "straggler", age))
        for ident in recovered:
            if self._on_recover is not None:
                self._on_recover(ident)
        for ident, state, age in escalated:
            callback = self._on_dead if state == "dead" else self._on_straggler
            if callback is not None:
                callback(ident, age)

    def _flagged_as(self, state: str) -> List[object]:
        with self._lock:
            return [i for i, s in self._flagged.items() if s == state]

    def dead(self) -> List[object]:
        return self._flagged_as("dead")

    def stragglers(self) -> List[object]:
        return self._flagged_as("straggler")

    def last_seen(self) -> Dict[object, Tuple[int, float]]:
        with self._lock:
            return dict(self._last_seen)

    def forget(self, ident: object) -> None:
        """Drop one identity entirely."""
        with self._lock:
            self._last_seen.pop(ident, None)
            self._flagged.pop(ident, None)


class HeartbeatMonitor:
    """Liveness over the store: stamp ``heartbeat/<rank>`` every
    ``interval_s``, watch every peer's stamp age, and escalate --
    *straggler* past ``straggler_after_s`` (span event +
    ``coord.stragglers``), *dead* past ``dead_after_s`` (span event +
    ``coord.dead_hosts``).  Verdicts are advisory for waits in flight.
    ``poll_once`` is the deterministic unit the tests drive; :meth:`start`
    runs it on a daemon thread (the in-process fake's mode)."""

    def __init__(self, client, interval_s: Optional[float] = None,
                 straggler_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None) -> None:
        self.client = client
        self.interval_s = heartbeat_interval_s() if interval_s is None else float(interval_s)
        self.straggler_after_s = (3.0 * self.interval_s if straggler_after_s is None
                                  else float(straggler_after_s))
        self.dead_after_s = (_env_float("GP_COORD_DEAD_AFTER_S", 10.0 * self.interval_s)
                             if dead_after_s is None else float(dead_after_s))
        self._ledger = LivenessLedger(
            self.straggler_after_s, self.dead_after_s,
            on_straggler=lambda pid, age: (
                _bump("coord.stragglers"),
                _event("coord.straggler", pid=pid, stamp_age_s=age)),
            on_dead=lambda pid, age: (
                _bump("coord.dead_hosts"),
                _event("coord.dead_host", pid=pid, stamp_age_s=age)),
            on_recover=lambda pid: _event("coord.recovered", pid=pid),
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._beats = 0
        self._last_poll: Optional[float] = None

    def poll_once(self) -> None:
        from spark_gp_tpu_torch.resilience import chaos

        cl = self.client
        now = cl.clock()
        if not chaos.heartbeats_suppressed():
            self._beats += 1
            cl.set(f"heartbeat/{cl.process_id}",
                   json.dumps({"n": self._beats, "t": now}).encode())
            _bump("coord.heartbeats")
        parsed: Dict[object, int] = {}
        # a store cannot list a prefix: every rank's stamp key is known
        for pid in range(cl.num_processes):
            raw = cl.try_get(f"heartbeat/{pid}")
            if raw is None:
                continue
            try:
                parsed[pid] = int(json.loads(raw.decode())["n"])
            except (ValueError, KeyError):
                continue
        self._ledger.observe(now, parsed, expected=range(cl.num_processes),
                             skip=(cl.process_id,))

    def maybe_poll(self) -> None:
        """Rate-limited :meth:`poll_once` for the passive drive mode:
        coordination waits call this each loop turn; the poll runs at most
        once an interval.  Exceptions are swallowed -- liveness accounting
        must never fail a fit."""
        now = self.client.clock()
        if self._last_poll is not None and now - self._last_poll < self.interval_s:
            return
        self._last_poll = now
        try:
            self.poll_once()
        except Exception:  # noqa: BLE001 -- see docstring
            pass

    def dead_pids(self) -> List[int]:
        return sorted(self._ledger.dead())

    def stragglers(self) -> List[int]:
        return sorted(self._ledger.stragglers())

    def snapshot(self) -> dict:
        return {
            "process_id": self.client.process_id,
            "process_count": self.client.num_processes,
            "interval_s": self.interval_s,
            "stragglers": sorted(self._ledger.stragglers()),
            "dead": sorted(self._ledger.dead()),
            "last_seen": {str(p): {"n": n, "at": at}
                          for p, (n, at) in self._ledger.last_seen().items()},
        }

    def start(self) -> "HeartbeatMonitor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="gp-coord-heartbeat",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 -- liveness must never crash a fit
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# --------------------------------------------------------------------------
# the key-value-store fit context
# --------------------------------------------------------------------------


class DcnContext:
    """One process's handle on a store-coordinated fit.

    Holds the client, this rank / the world size, the heartbeat monitor,
    and a round counter a name so every rank's k-th gather lands on the
    same keys (the fit is deterministic lockstep: every branch that could
    diverge is driven by values summed over the store)."""

    def __init__(self, client, monitor: Optional[HeartbeatMonitor] = None,
                 timeout_s: Optional[float] = None) -> None:
        from spark_gp_tpu_torch.resilience import integrity

        self.client = client
        self.process_id = int(client.process_id)
        self.num_processes = int(client.num_processes)
        self.monitor = monitor
        self.timeout_s = timeout_s
        self._rounds: Dict[str, int] = {}
        self._lock = threading.Lock()
        # the trust plane's ledger of the peers, and the armed spot check
        # (integrity.stage_spot_check)
        self.trust = integrity.make_trust_ledger()
        self.dup_check = None
        #: gathers this context made, by name (a fit's store traffic)
        self.gathers: Dict[str, int] = {}
        #: the rung each spot check's claim met (``integrity.ladder_rung``)
        self.audits: List[Optional[str]] = []

    def _round(self, name: str) -> int:
        with self._lock:
            r = self._rounds.get(name, 0)
            self._rounds[name] = r + 1
            return r

    def allgather_bytes(self, name: str, payload: bytes) -> List[bytes]:
        """A payload a rank, in rank order (one store round); the round
        counter sequences repeated gathers under one name."""
        r = self._round(name)
        self.gathers[name] = self.gathers.get(name, 0) + 1
        out = kv_allgather(f"{name}/{r}", payload, client=self.client, timeout_s=self.timeout_s,
                           monitor=self.monitor, trust=self.trust)
        if r >= 2:
            # this rank's own round r-2 key is drained: round r completes
            # only once every peer PUBLISHED round r, i.e. finished reading
            # every earlier round
            self.client.delete(f"ag/{name}/{r - 2}/{self.process_id}")
        return out

    def allgather_arrays(self, name: str, *arrays: np.ndarray) -> List[List[np.ndarray]]:
        """Array tuples a rank, in rank order (one store round).  The
        magnitude attestation: a contribution carrying a finite value past
        ``GP_INTEGRITY_MAX_ABS`` is attributed to its publisher and refused
        on every rank alike, before any sum folds it in.  Non-finite values
        pass -- the vag round exchanges them on purpose."""
        from spark_gp_tpu_torch.resilience import chaos, integrity

        # the wrong-COMPUTE fault: the scale kind corrupts this rank's
        # values before they are packed and sealed
        arrays = chaos.maybe_corrupt_arrays(name, self.process_id,
                                            [np.asarray(a) for a in arrays])
        parts = [_unpack_arrays(p) for p in self.allgather_bytes(name, _pack_arrays(arrays))]
        if integrity.enabled():
            for pid, contribution in enumerate(parts):
                if integrity.bounds_violation(contribution):
                    _bump("integrity.bounds_violations")
                    _event("integrity.bounds_violation", op=name, pid=pid)
                    self.trust.record_disagreement(pid, definitive=True, reason="bounds")
                    raise integrity.AttestationError(
                        f"collective {name!r}: pid {pid} published a finite contribution "
                        f"beyond the magnitude attestation bar ({integrity.max_abs_bound():.1e})"
                        " -- corrupted compute attributed at the gather",
                        pid=pid, code="bounds")
        return parts

    def allreduce_arrays(self, name: str, *arrays) -> List[np.ndarray]:
        """Sums over the ranks: every rank receives the contributions in
        rank order and adds them in that order in float64, so the result is
        bit-identical on every rank."""
        parts = self.allgather_arrays(name, *[np.asarray(a) for a in arrays])
        out = []
        for i in range(len(arrays)):
            acc = np.zeros_like(np.asarray(parts[0][i], dtype=np.float64))
            for contribution in parts:
                acc = acc + np.asarray(contribution[i], dtype=np.float64)
            out.append(acc)
        return out

    def wrap_value_and_grad(self, value_and_grad):
        """The objective summed over the store: ``(theta, *carry) ->
        (value, grad, *carry)`` with this rank's value and gradient in and
        the sums out (a latent family's carry, its modes or sites, stays
        local).  This rank's preemption flag rides the same round, so when
        any rank has been signalled every rank stops together at the next
        evaluation with :class:`PreemptedError`; a sampled round also runs
        the duplicate-dispatch spot check (``resilience/integrity.py``)."""

        def reduced(theta, *carry):
            value, grad, *rest = value_and_grad(theta, *carry)
            # non-finite locals are exchanged like any other value (skipping
            # a round would desynchronize the counters); the sum carries the
            # non-finite result to every rank alike
            s_value, s_grad, s_preempt = self.allreduce_arrays(
                "vag", np.asarray([float(np.asarray(value))], dtype=np.float64),
                np.asarray(grad, dtype=np.float64),
                np.asarray([1.0 if preemption_requested() else 0.0], dtype=np.float64))
            if float(s_preempt[0]) > 0.0:
                note_preemption_observed()
                consume_preemption()
                raise PreemptedError(
                    f"preemption signalled on at least one rank: all {self.num_processes} "
                    "processes stop at this evaluation; the last coordinated checkpoint is "
                    "complete -- resume after rescheduling")
            if self.dup_check is not None:
                from spark_gp_tpu_torch.resilience import integrity

                # a pure hash of the round index: every rank audits together
                k = self._rounds.get("vag", 1) - 1
                if integrity.should_spot_check(k):
                    self.audits.append(integrity.run_spot_check(self, theta, k))
            return (float(s_value[0]), s_grad, *rest)

        return reduced


_DCN_FORCED = threading.local()  # .ctx a thread: tests run one logical rank a thread


def set_dcn_context_for_testing(ctx: Optional[DcnContext]):
    """Install a context for THIS THREAD (tests simulate ranks with one
    thread and an :class:`InProcessCoordClient` each); ``None`` restores
    the process's own."""
    _DCN_FORCED.ctx = ctx


def _forced_ctx() -> Optional[DcnContext]:
    return getattr(_DCN_FORCED, "ctx", None)


def _process_count() -> int:
    from spark_gp_tpu_torch.parallel.distributed import num_processes

    return num_processes()


def dcn_required() -> bool:
    """True when the key-value-store fit mode applies: a group of several
    processes and ``GP_DCN_MODE`` set to ``1`` / ``on`` / ``true``.  The
    JAX package also enters the mode on its own when its backend cannot
    run one program across processes; a process group's collectives always
    cross processes, so here only the switch enters it."""
    if _process_count() <= 1:
        return False
    return os.environ.get("GP_DCN_MODE", "").strip().lower() in ("1", "on", "true")


_DCN_SINGLETON: Optional[DcnContext] = None
_BARE_SINGLETON: Optional[DcnContext] = None
_DCN_LOCK = threading.Lock()


def checkpoint_coordination_context() -> Optional[DcnContext]:
    """The context coordinated CHECKPOINTS use: the store-mode fit context
    when the mode applies, else one CACHED bare context over the client
    (cached, so its round counters -- which sequence the ``ckpt_resume``
    broadcast -- stay monotonic across fits)."""
    ctx = dcn_context()
    if ctx is not None:
        return ctx
    global _BARE_SINGLETON
    with _DCN_LOCK:
        if _BARE_SINGLETON is None:
            client = coord_client()
            if client is None or client.num_processes <= 1:
                return None
            _BARE_SINGLETON = DcnContext(client)
    return _BARE_SINGLETON


def dcn_context() -> Optional[DcnContext]:
    """The process's store-mode fit context, or ``None`` when the mode does
    not apply (:func:`dcn_required`)."""
    forced = _forced_ctx()
    if forced is not None:
        return forced
    if not dcn_required():
        return None
    return store_context()


def store_context() -> DcnContext:
    """The process's store-mode fit context, whether or not the mode is
    switched on: created once a process, with its heartbeat monitor.
    :func:`dcn_context` returns it under ``GP_DCN_MODE``, the distributed
    ladder's ``dcn_fallback`` rung without it.  Raises when the group was
    not brought up by ``distributed.initialize`` (no store to sum over:
    every rank would fit its 1/P of the data)."""
    global _DCN_SINGLETON
    with _DCN_LOCK:
        if _DCN_SINGLETON is None:
            client = coord_client()
            if client is None:
                _bump("coord.degraded")
                raise RuntimeError(
                    "the key-value-store fit mode needs the store of a group brought up by "
                    "parallel.distributed.initialize; without it the objective cannot be "
                    "summed across the ranks and each would fit 1/P of the data")
            _DCN_SINGLETON = DcnContext(client, monitor=HeartbeatMonitor(client))
    return _DCN_SINGLETON


def dcn_fallback_available(current_ctx=None) -> bool:
    """Whether the distributed ladder's ``dcn_fallback`` rung can engage
    for a failing sharded fit (``resilience/fallback.py``): a multi-process
    group whose store is reachable and which is NOT already coordinating
    over it (``current_ctx`` is the fit's bound context, if any).  One
    process answers False and the ladder falls to ``single_host``.

    Departure: the JAX package also asks :func:`dcn_required`, because on a
    backend with real cross-process execution its rung would re-run the
    same sharded path.  Here the rung re-runs the fit over the store, not
    over the process group whose collective failed, so the switch does
    not gate it."""
    if current_ctx is not None or _forced_ctx() is not None:
        return False
    try:
        if _process_count() <= 1:
            return False
    except RuntimeError:
        return False
    return coord_client() is not None


def ranks_agree(name: str, vote: bool) -> bool:
    """One round over :func:`store_context` in which every rank casts
    ``vote``: True when every rank voted yes.  A decision that one rank
    alone observed (a failure that takes a ladder rung) is taken by every
    rank or by none; a rank that never votes is named by the deadline."""
    votes = store_context().allgather_bytes(f"agree/{name}", b"1" if vote else b"0")
    return all(v == b"1" for v in votes)


def liveness_snapshot() -> Optional[dict]:
    """Coordination liveness for health surfaces (the serve ``health``
    verb): ``None`` for one process, else the heartbeat monitor's view plus
    the topology."""
    ctx = _forced_ctx() or _DCN_SINGLETON
    if ctx is not None and ctx.monitor is not None:
        return ctx.monitor.snapshot()
    client = coord_client()
    if client is None or client.num_processes <= 1:
        return None
    return {"process_id": client.process_id, "process_count": client.num_processes,
            "stragglers": [], "dead": [],
            "note": "no heartbeat monitor active (no store-mode fit ran)"}


def store_mesh(ctx: DcnContext, device):
    """The mesh of a store-mode fit: this rank and the world size of
    ``ctx`` on ``device``, every collective a round over the store
    (``parallel/mesh.ExpertMesh`` with ``backend="store"``), so no
    process-group collective runs in the fit."""
    import torch

    from spark_gp_tpu_torch.parallel.mesh import ExpertMesh

    return ExpertMesh(None, ctx.process_id, ctx.num_processes, torch.device(device), "store",
                      ctx)


# --------------------------------------------------------------------------
# active-set sampling over the store (the takeSample analogue)
# --------------------------------------------------------------------------


def sample_active_dcn(ctx: DcnContext, data, m: int, seed: int) -> np.ndarray:
    """A uniform global active set when no rank holds every row: publish the
    valid-row counts, draw the same m global indices from the shared seed
    on every rank, gather exactly the selected rows.  The traffic is the m
    chosen rows."""
    x = data.x.detach().cpu().numpy() if hasattr(data.x, "detach") else np.asarray(data.x)
    mask = data.mask.detach().cpu().numpy() if hasattr(data.mask, "detach") \
        else np.asarray(data.mask)
    p = x.shape[-1]
    flat_x = x.reshape(-1, p)
    valid = np.flatnonzero(mask.reshape(-1) > 0)
    counts = [int(part[0][0]) for part in ctx.allgather_arrays(
        "active_counts", np.asarray([valid.size], dtype=np.int64))]
    total = int(sum(counts))
    m = min(int(m), total)
    sel = np.sort(np.random.default_rng(seed).choice(total, size=m, replace=False))
    offset = int(sum(counts[: ctx.process_id]))
    mine = sel[(sel >= offset) & (sel < offset + counts[ctx.process_id])]
    rows = flat_x[valid[mine - offset]].astype(np.float64)
    parts = ctx.allgather_arrays("active_rows", rows)
    # rank-ordered concatenation is the global sorted-index order
    return np.concatenate([np.asarray(part[0]).reshape(-1, p) for part in parts], axis=0)


# --------------------------------------------------------------------------
# cross-process trace stitching
# --------------------------------------------------------------------------


def stitch_trace_token(ctx=None) -> str:
    """ONE trace id a (possibly multi-process) fit: every rank mints a
    local candidate and, when a context spans processes, adopts rank 0's,
    so every rank's run journal of one distributed fit carries the same
    ``trace_id``.  Best-effort: a coordination failure here keeps the local
    token, and the fit's own guarded collectives raise the named error."""
    from spark_gp_tpu_torch.obs.runtime import new_trace_token

    local = new_trace_token()
    if ctx is None or getattr(ctx, "num_processes", 1) <= 1:
        return local
    try:
        return ctx.allgather_bytes("trace_id", local.encode("ascii"))[0].decode("ascii")
    except Exception:  # noqa: BLE001 -- telemetry stitch only, see docstring
        import logging

        logging.getLogger("spark_gp_tpu_torch").warning(
            "trace-id stitch failed; journals keep per-rank trace ids", exc_info=True)
        return local


# --------------------------------------------------------------------------
# elastic-resume metadata
# --------------------------------------------------------------------------


def elastic_meta(mesh=None, num_experts: Optional[int] = None,
                 expert_size: Optional[int] = None,
                 process_count: Optional[int] = None) -> dict:
    """The ``(process_count, mesh_shape, expert_assignment)`` stamp every
    coordinated checkpoint carries (``utils/checkpoint.py`` reads the
    ``"elastic"`` key): a P-rank fit may resume on P' ranks, but a payload
    whose identity (kernel, data, shapes) differs is an
    ``ElasticResumeError``, never a silent restart."""
    from spark_gp_tpu_torch.parallel.mesh import mesh_shape

    return {
        "process_count": _process_count() if process_count is None else int(process_count),
        "mesh_shape": mesh_shape(mesh),
        "expert_assignment": {
            "num_experts": None if num_experts is None else int(num_experts),
            "expert_size": None if expert_size is None else int(expert_size),
        },
    }


# --------------------------------------------------------------------------
# coordinated checkpointing
# --------------------------------------------------------------------------


class _CoordinatedWriter:
    """The protocol both coordinated checkpointers share.

    Save step k: rank 0 runs the inner atomic writer, then every rank
    contributes the digest of the payload *it would have written* (and its
    preemption flag) to one deadline-guarded gather -- identical lockstep
    states give identical digests, so a divergent rank surfaces as a
    checkpoint error ON EVERY RANK, and a rank that never arrives is named
    by the deadline.

    The era (the context's counter a tag) namespaces each fit's rounds: a
    refit constructs a fresh checkpointer whose save counter restarts at
    1, and without the era its keys would meet the previous fit's.  With
    no context (one process) the writer saves alone."""

    def __init__(self, ctx: Optional[DcnContext], tag: str) -> None:
        self.ctx = ctx
        era = 0 if ctx is None else ctx._round(f"ckpt_era/{tag}")
        self.tag = f"{tag}/e{era}"
        self.saves = 0

    def _coordinate(self, write_fn, digest: str) -> None:
        """One gather a save carries ``<digest>|<preempt_flag>`` from every
        rank: the gather is the rendezvous, rank 0 writes BEFORE publishing
        (a peer receiving the payload knows the file is complete), the
        digests are compared all-to-all (every rank raises
        ``CheckpointMismatchError`` naming the divergent ranks), and a
        preemption on any rank stops every rank here, together, after the
        save completed."""
        self.saves += 1
        ctx = self.ctx
        if ctx is None or ctx.num_processes <= 1:
            write_fn()
            _bump("coord.checkpoints")
            return
        step = self.saves
        if ctx.process_id == 0:
            write_fn()
        preempt = "1" if preemption_requested() else "0"
        payloads = ctx.allgather_bytes(f"ckpt/{self.tag}", f"{digest}|{preempt}".encode())
        entries = [p.decode().split("|", 1) for p in payloads]
        divergent = sorted(pid for pid, (d, _) in enumerate(entries) if d != digest)
        if divergent:
            from spark_gp_tpu_torch.utils.checkpoint import CheckpointMismatchError

            raise CheckpointMismatchError(
                f"coordinated checkpoint {self.tag!r} step {step}: state digests diverge "
                f"across ranks (process(es) {divergent} differ from process {ctx.process_id})"
                " -- the lockstep trajectories have forked")
        _bump("coord.checkpoints")
        _event("coord.checkpoint", tag=self.tag, step=step)
        if any(flag == "1" for _, flag in entries):
            note_preemption_observed()
            consume_preemption()
            raise PreemptedError(
                f"preemption signalled on at least one rank: the coordinated checkpoint "
                f"(step {step}) just completed on every process -- resume after rescheduling")


class CoordinatedLbfgsCheckpointer(_CoordinatedWriter):
    """The multi-rank shell of ``utils/checkpoint.LbfgsCheckpointer``: the
    same cadence and payload, but only rank 0 touches the disk and every
    rank cross-checks the payload digest through the store."""

    def __init__(self, inner, ctx: Optional[DcnContext]) -> None:
        super().__init__(ctx, tag=os.path.basename(inner.path))
        self.inner = inner

    @property
    def path(self):
        return self.inner.path

    @property
    def iteration(self):
        return self.inner.iteration

    @iteration.setter
    def iteration(self, value):
        self.inner.iteration = value

    def record(self, theta, value, grad) -> None:
        self.inner.record(theta, value, grad)

    def __call__(self, theta) -> None:
        from spark_gp_tpu_torch.resilience import chaos
        from spark_gp_tpu_torch.utils.checkpoint import _raise_if_preempted

        payload = self.inner.build_payload(theta)
        self._coordinate(lambda: self.inner.write_payload(payload), payload["checksum"])
        # tick AFTER the coordinated round: "kill after N saves" leaves N
        # saves complete on every rank
        chaos.tick_kill_counter()
        _raise_if_preempted()


class CoordinatedDeviceCheckpointer(_CoordinatedWriter):
    """The multi-rank shell of ``utils/checkpoint.DeviceOptimizerCheckpointer``:
    rank 0 writes the npz at each segment boundary, every rank checks the
    npz digest through the store.

    ``load`` broadcasts: only rank 0 is sure to hold the file (it is the
    writer), so rank 0 loads and validates (the elastic checks included)
    and ships the state's leaves (``lbfgs_device.STATE_FIELDS``) over the
    store; every rank then resumes from the same segment."""

    def __init__(self, inner, ctx: Optional[DcnContext]) -> None:
        super().__init__(ctx, tag=os.path.basename(inner.path))
        self.inner = inner

    @property
    def path(self):
        return self.inner.path

    def save(self, state, meta: dict) -> None:
        from spark_gp_tpu_torch.utils.checkpoint import _npz_digest

        arrays = self.inner.build_arrays(state, meta)
        self._coordinate(lambda: self.inner.write_arrays(arrays), _npz_digest(arrays))

    def load(self, template, meta: dict):
        from spark_gp_tpu_torch.optimize.lbfgs_device import _LbfgsState

        ctx = self.ctx
        if ctx is None or ctx.num_processes <= 1:
            return self.inner.load(template, meta)
        state = self.inner.load(template, meta) if ctx.process_id == 0 else None
        blob = b"" if state is None else _pack_arrays([np.asarray(v) for v in state])
        parts = ctx.allgather_bytes(f"ckpt_load/{self.tag}", blob)
        if not parts[0]:
            return None  # rank 0 had nothing resumable
        return _LbfgsState(*_unpack_arrays(parts[0]))


# --------------------------------------------------------------------------
# preemption watcher
# --------------------------------------------------------------------------

_PREEMPTION = threading.Event()
_PREEMPTION_OBSERVED = threading.Event()
_WATCHER_INSTALLED = False


def install_preemption_watcher() -> bool:
    """SIGTERM -> one final coordinated save, then stop.  The handler only
    sets a flag (metrics and span events take locks the interrupted thread
    may hold: a self-deadlock inside a handler); the next save boundary
    (``utils/checkpoint.run_segmented``, the host checkpointer, the store
    mode's vag round) records it and raises :class:`PreemptedError`.
    This PERMANENT installation is the opt-in for long-lived training
    drivers; the fit paths use the scoped :func:`preemption_watch`.
    Idempotent; returns False off the main thread."""
    global _WATCHER_INSTALLED
    if _WATCHER_INSTALLED:
        return True
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, _sigterm_flag_handler(prev))
    _WATCHER_INSTALLED = True
    return True


def make_flag_handler(flag: threading.Event, prev=None):
    """THE flag-only signal-handler factory every installer shares (the
    preemption watchers here, the serve drain in ``serve/lifecycle.py``):
    set the flag and nothing else, then chain a real previous handler."""
    import signal

    def _on_signal(signum, frame):
        flag.set()
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    return _on_signal


def _sigterm_flag_handler(prev):
    return make_flag_handler(_PREEMPTION, prev)


_WATCH_DEPTH = 0
_WATCH_PREV = None


def preemption_watch():
    """Scoped SIGTERM watcher for checkpointed optimize loops: the handler
    is installed only WHILE a save boundary exists to act on the flag, and
    the previous disposition comes back on exit.  A SIGTERM that arrived
    in the scope but was never consumed at a save boundary is RE-DELIVERED
    after the handler is restored.  Re-entrant; a no-op off the main
    thread."""
    import contextlib

    @contextlib.contextmanager
    def _watch():
        global _WATCH_DEPTH, _WATCH_PREV
        import signal

        on_main = threading.current_thread() is threading.main_thread()
        installed = False
        if on_main and not _WATCHER_INSTALLED:
            if _WATCH_DEPTH == 0:
                _WATCH_PREV = signal.getsignal(signal.SIGTERM)
                signal.signal(signal.SIGTERM, _sigterm_flag_handler(_WATCH_PREV))
            _WATCH_DEPTH += 1
            installed = True
        try:
            yield
        finally:
            if installed:
                _WATCH_DEPTH -= 1
                if _WATCH_DEPTH == 0:
                    signal.signal(signal.SIGTERM, _WATCH_PREV)
                    _WATCH_PREV = None
                    if _PREEMPTION.is_set():
                        # deferred delivery under the RESTORED disposition
                        _PREEMPTION.clear()
                        os.kill(os.getpid(), signal.SIGTERM)

    return _watch()


def preemption_requested() -> bool:
    from spark_gp_tpu_torch.resilience import chaos

    return _PREEMPTION.is_set() or chaos.preemption_staged()


def consume_preemption() -> None:
    """Clear the flag once a save boundary acted on it: a consumed
    preemption must not poison the process's next checkpointed fit."""
    _PREEMPTION.clear()


def note_preemption_observed() -> None:
    """Record the preemption in telemetry ONCE, outside the handler."""
    if _PREEMPTION_OBSERVED.is_set():
        return
    _PREEMPTION_OBSERVED.set()
    _bump("coord.preemptions")
    _event("coord.preempted", signal="SIGTERM")


def clear_preemption_for_testing() -> None:
    _PREEMPTION.clear()
    _PREEMPTION_OBSERVED.clear()


class PreemptedError(RuntimeError):
    """The fit stopped at a save boundary because preemption was signalled:
    the checkpoint on disk is complete and current, and a resume after
    rescheduling continues there."""
