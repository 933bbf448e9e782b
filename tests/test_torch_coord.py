"""The coordination plane of the port (``parallel/coord.py``) against the
JAX package's (``tests/test_coord.py``).

Logical ranks run as threads sharing an :class:`InProcessCoordStore`
(deadlines on a fake clock where real waiting would cost seconds), as
the JAX package's tests run them; both packages run the same scenarios
side by side where the protocol is shared: the barrier's missing ranks,
the gather's order, the float64 sum (bit-equal), the liveness state
machine, the elastic stamp, the store-mode regression fit on two ranks
(theta within 1e-6 relative of the JAX package's, the ranks bit-equal to
each other) and host checkpoints written by two ranks of either package
resuming in one process of the other.  Two real gloo ranks
(``_torch_mesh_worker.MeshPool``, a ``FileStore``) hold the store
barrier's deadline, the store-mode fit against the group-sharded fit
with no process-group collective made, and the coordinated checkpoints
with a staged preemption on the host and the CPU device optimizer.  The
collective-guard lint closes the file."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import ast
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import _torch_mesh_worker as w
import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.parallel import coord as jcoord
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.parallel import coord
from spark_gp_tpu_torch.parallel.coord import (
    CoordinationTimeoutError,
    DcnContext,
    HeartbeatMonitor,
    InProcessCoordStore,
)
from spark_gp_tpu_torch.parallel.experts import group_for_experts
from spark_gp_tpu_torch.resilience import chaos


class FakeClock:
    """A clock whose ``sleep`` advances time: a 120 s deadline resolves in
    microseconds."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += max(float(dt), 1e-4)


def _client(store, pid, nproc, clock=None, pkg=coord):
    return pkg.InProcessCoordClient(store, pid, nproc,
                                    clock=clock if clock is not None else time.monotonic,
                                    sleep=clock.sleep if clock is not None else None)


def _counter(key):
    return telemetry.snapshot()["counters"].get(key, 0.0)


def _threads(fns):
    """One callable a logical rank on its own thread: ``{rank: result or
    exception}``."""
    outcomes = {}

    def runner(pid, fn):
        try:
            outcomes[pid] = fn()
        except BaseException as exc:  # noqa: BLE001 -- collected for the asserts
            outcomes[pid] = exc

    threads = [threading.Thread(target=runner, args=(pid, fn)) for pid, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outcomes


# -- barriers and gathers, both packages ----------------------------------------


@pytest.mark.parametrize("pkg", [coord, jcoord], ids=["port", "jax"])
def test_barrier_timeout_names_missing_processes_fake_clock(pkg):
    clock = FakeClock()
    c0 = _client(pkg.InProcessCoordStore(), 0, 3, clock, pkg)
    t0 = time.monotonic()
    with pytest.raises(pkg.CoordinationTimeoutError) as err:
        c0.barrier("b", timeout_s=120.0)
    assert time.monotonic() - t0 < 5.0  # fake clock: no real 120 s wait
    assert err.value.missing == (1, 2)
    assert "missing process id(s) [1, 2]" in str(err.value)
    assert err.value.timeout_s == 120.0


def test_barrier_completes_across_threads():
    store = InProcessCoordStore()

    def arrive(pid):
        def run():
            time.sleep(0.05 * pid)
            _client(store, pid, 2).barrier("sync", timeout_s=10.0)
        return run

    assert _threads([arrive(0), arrive(1)]) == {0: None, 1: None}


@pytest.mark.parametrize("pkg", [coord, jcoord], ids=["port", "jax"])
def test_kv_allgather_orders_by_pid(pkg):
    store = pkg.InProcessCoordStore()
    out = _threads([
        (lambda pid: lambda: pkg.kv_allgather("g/0", f"payload-{pid}".encode(),
                                               client=_client(store, pid, 3, pkg=pkg),
                                               timeout_s=10.0))(pid)
        for pid in range(3)])
    expected = [b"payload-0", b"payload-1", b"payload-2"]
    assert out[0] == out[1] == out[2] == expected


@pytest.mark.parametrize("pkg", [coord, jcoord], ids=["port", "jax"])
def test_kv_allgather_timeout_names_dead_process(pkg):
    c0 = _client(pkg.InProcessCoordStore(), 0, 2, FakeClock(), pkg)
    with pytest.raises(pkg.CoordinationTimeoutError) as err:
        pkg.kv_allgather("g/1", b"x", client=c0, timeout_s=60.0)
    assert err.value.missing == (1,)


def _allreduce(pkg):
    store = pkg.InProcessCoordStore()

    def reduce(pid):
        def run():
            ctx = pkg.DcnContext(_client(store, pid, 2, pkg=pkg), timeout_s=10.0)
            rng = np.random.default_rng(40 + pid)
            return ctx.allreduce_arrays("vag", np.asarray([1.25 if pid == 0 else 2.5]),
                                        rng.normal(size=7) * 10.0 ** rng.integers(-8, 8, 7))
        return run

    return _threads([reduce(0), reduce(1)])


def test_allreduce_is_deterministic_and_bit_equal_to_jax():
    port, jax_ = _allreduce(coord), _allreduce(jcoord)
    for i in range(2):
        np.testing.assert_array_equal(port[0][i], port[1][i])
        np.testing.assert_array_equal(port[0][i], jax_[0][i])
    np.testing.assert_allclose(port[0][0], [3.75])


# -- heartbeat and liveness ---------------------------------------------------------


def test_heartbeat_monitor_flags_straggler_then_dead_then_recovery():
    clock = FakeClock()
    store = InProcessCoordStore()
    m0, m1 = (HeartbeatMonitor(_client(store, p, 2, clock), interval_s=1.0,
                               straggler_after_s=3.0, dead_after_s=10.0) for p in range(2))
    stragglers_before, dead_before = _counter("coord.stragglers"), _counter("coord.dead_hosts")
    m0.poll_once()
    m1.poll_once()
    m0.poll_once()
    assert m0.stragglers() == [] and m0.dead_pids() == []
    clock.t += 5.0
    m0.poll_once()
    assert m0.stragglers() == [1]
    assert _counter("coord.stragglers") == stragglers_before + 1
    clock.t += 6.0
    m0.poll_once()
    assert m0.dead_pids() == [1] and m0.stragglers() == []
    assert _counter("coord.dead_hosts") == dead_before + 1
    m1.poll_once()
    m0.poll_once()
    assert m0.dead_pids() == [] and m0.stragglers() == []
    snap = m0.snapshot()
    assert snap["process_count"] == 2 and snap["dead"] == [] and snap["stragglers"] == []


def test_heartbeat_flags_peer_that_never_stamped():
    clock = FakeClock()
    m0 = HeartbeatMonitor(_client(InProcessCoordStore(), 0, 2, clock), interval_s=1.0,
                          straggler_after_s=3.0, dead_after_s=10.0)
    m0.poll_once()
    clock.t += 50.0
    m0.poll_once()
    assert m0.dead_pids() == [1]


def test_allgather_aborts_early_on_dead_verdict():
    c0 = _client(InProcessCoordStore(), 0, 2)  # real clock: the EARLY abort
    t0 = time.monotonic()
    with pytest.raises(CoordinationTimeoutError) as err:
        coord.kv_allgather("g/2", b"x", client=c0, timeout_s=30.0, dead_pids=lambda: [1])
    assert time.monotonic() - t0 < 5.0
    assert err.value.missing == (1,)


def _ledger_events(pkg, script):
    events = []
    ledger = pkg.LivenessLedger(
        straggler_after_s=3.0, dead_after_s=10.0,
        on_straggler=lambda i, age: events.append(("straggler", i)),
        on_dead=lambda i, age: events.append(("dead", i)),
        on_recover=lambda i: events.append(("recover", i)))
    states = []
    for now, stamps, expected in script:
        ledger.observe(now, stamps, expected=expected)
        states.append((sorted(ledger.stragglers()), sorted(ledger.dead()),
                       sorted(ledger.last_seen().items())))
    return events, states


def test_liveness_ledger_matches_jax_on_the_same_stamps():
    """Re-escalation after recovery, a peer dead before its first stamp,
    and a counter rollover: the same stamps give the same states and
    callbacks in both packages."""
    script = [(0.0, {"r1": 1}, ("r0", "r1", "r2")), (4.0, {"r1": 1, "r0": 1}, ()),
              (5.0, {"r1": 2, "r0": 2}, ()), (9.1, {"r1": 2, "r0": 3}, ()),
              (11.0, {"r1": 2, "r0": 4}, ()), (16.0, {"r1": 2, "r0": 5}, ()),
              (17.0, {"r1": 1, "r0": 6}, ()), (30.0, {}, ())]
    port, jax_ = _ledger_events(coord, script), _ledger_events(jcoord, script)
    assert port == jax_
    events, _ = port
    assert ("dead", "r2") in events and ("recover", "r1") in events
    assert events.count(("straggler", "r1")) == 2


def test_liveness_ledger_recovered_peer_reescalates():
    events, _ = _ledger_events(coord, [(0.0, {"r1": 1}, ()), (4.0, {"r1": 1}, ()),
                                       (5.0, {"r1": 2}, ()), (9.1, {"r1": 2}, ()),
                                       (16.0, {"r1": 2}, ())])
    assert events == [("straggler", "r1"), ("recover", "r1"), ("straggler", "r1"),
                      ("dead", "r1")]


def test_liveness_ledger_dead_before_first_stamp_and_forget():
    ledger = coord.LivenessLedger(3.0, 10.0)
    ledger.observe(0.0, {"r0": 1}, expected=("r0", "r1"))
    ledger.observe(11.0, {"r0": 2}, expected=("r0", "r1"))
    assert ledger.dead() == ["r1"] and ledger.stragglers() == []
    assert ledger.last_seen()["r1"] == (-1, 0.0)
    ledger.forget("r1")
    assert ledger.dead() == [] and "r1" not in ledger.last_seen()


def test_liveness_snapshot_none_single_process():
    assert coord.liveness_snapshot() is None


def test_serve_health_reports_coord_liveness_when_distributed():
    clock = FakeClock()
    store = InProcessCoordStore()
    monitor = HeartbeatMonitor(_client(store, 0, 2, clock), interval_s=1.0,
                               straggler_after_s=3.0, dead_after_s=10.0)
    coord.set_dcn_context_for_testing(DcnContext(_client(store, 0, 2), monitor=monitor))
    try:
        monitor.poll_once()
        _client(store, 1, 2, clock).set("heartbeat/1", json.dumps({"n": 1, "t": 0.0}).encode())
        monitor.poll_once()
        clock.t += 50.0
        monitor.poll_once()
        from spark_gp_tpu_torch.serve.server import GPServeServer

        health = GPServeServer(device="cpu").health()
        assert health["coord"]["dead"] == [1]
        assert health["status"] in ("degraded", "unready")
        assert coord.liveness_snapshot()["dead"] == [1]
    finally:
        coord.set_dcn_context_for_testing(None)


# -- the mesh faults ------------------------------------------------------------------


def test_straggler_host_delays_guarded_collective():
    with chaos.StragglerHost(0.05):
        assert chaos.apply_straggler_delay("any_op") == 0.05
    assert chaos.apply_straggler_delay("any_op") == 0.0
    with chaos.StragglerHost(0.05, op="vag"):
        assert chaos.apply_straggler_delay("ckpt") == 0.0
        assert chaos.apply_straggler_delay("vag/3") == 0.05


def test_dead_host_raises_before_collective():
    with chaos.DeadHost(exit_process=False):
        assert chaos.heartbeats_suppressed()
        with pytest.raises(chaos.SimulatedPreemption):
            coord.guard_collective("stitch")
    assert not chaos.heartbeats_suppressed()


def test_kill_process_after_validates():
    with pytest.raises(ValueError):
        chaos.kill_process_after(0)


# -- elastic metadata and coordinated checkpoints -------------------------------------


def test_mesh_shape_and_elastic_meta_match_jax():
    import jax

    from spark_gp_tpu.parallel.mesh import expert_mesh as j_expert_mesh
    from spark_gp_tpu_torch.parallel.mesh import ExpertMesh, mesh_shape

    assert mesh_shape(None) is None
    n = len(jax.devices())
    t_mesh = ExpertMesh(None, 0, n, torch.device("cpu"), "none")
    args = dict(num_experts=8, expert_size=16, process_count=4)
    port = coord.elastic_meta(t_mesh, **args)
    assert port == jcoord.elastic_meta(j_expert_mesh(), **args)
    assert port["mesh_shape"] == [["experts", n]]
    json.dumps(port)


def _state(n=3):
    from spark_gp_tpu_torch.optimize.lbfgs_device import STATE_FIELDS, _LbfgsState

    rng = np.random.default_rng(9)
    return _LbfgsState(*[rng.normal(size=(n,)) for _ in STATE_FIELDS])


def _template(state):
    from spark_gp_tpu_torch.optimize.lbfgs_device import STATE_FIELDS

    return {f: (np.asarray(v).shape, np.asarray(v).dtype) for f, v in zip(STATE_FIELDS, state)}


def test_elastic_device_checkpoint_resumes_across_process_counts(tmp_path):
    from spark_gp_tpu_torch.utils.checkpoint import (
        DeviceOptimizerCheckpointer,
        ElasticResumeError,
    )

    state, meta = _state(), {"kind": "t", "theta_dim": 3}

    def stamp(p):
        return coord.elastic_meta(None, num_experts=8, expert_size=16, process_count=p)

    DeviceOptimizerCheckpointer(str(tmp_path), "el", elastic=stamp(2)).save(state, meta)
    before = _counter("coord.elastic_resumes")
    reader = DeviceOptimizerCheckpointer(str(tmp_path), "el", elastic=stamp(1))
    loaded = reader.load(_template(state), meta)
    np.testing.assert_array_equal(loaded.theta, state.theta)
    assert _counter("coord.elastic_resumes") == before + 1
    with pytest.raises(ElasticResumeError, match="2-process coordinated"):
        reader.load(_template(state), {"kind": "t", "theta_dim": 4})


def test_coordinated_host_checkpointer_writer_election_and_digest(tmp_path):
    from spark_gp_tpu_torch.utils.checkpoint import LbfgsCheckpointer, load_checkpoint_payload

    store, kernel = InProcessCoordStore(), tgp.RBFKernel(1.0)

    def host(pid):
        def run():
            ctx = DcnContext(_client(store, pid, 2), timeout_s=10.0)
            inner = LbfgsCheckpointer(str(tmp_path), kernel, tag="coordtest", seed=0,
                                      elastic=coord.elastic_meta(None, process_count=2))
            coord.CoordinatedLbfgsCheckpointer(inner, ctx)(np.asarray([0.5]))
        return run

    before = _counter("coord.checkpoints")
    assert _threads([host(0), host(1)]) == {0: None, 1: None}
    assert _counter("coord.checkpoints") == before + 2
    payload = load_checkpoint_payload(str(tmp_path), tag="coordtest")
    assert payload["iteration"] == 1 and payload["elastic"]["process_count"] == 2
    np.testing.assert_allclose(payload["theta"], [0.5])


def test_coordinated_device_checkpointer_load_broadcasts_from_writer(tmp_path):
    from spark_gp_tpu_torch.utils.checkpoint import DeviceOptimizerCheckpointer

    state, meta = _state(), {"kind": "t"}
    DeviceOptimizerCheckpointer(str(tmp_path / "p0"), "bc").save(state, meta)
    store = InProcessCoordStore()

    def host(pid):
        def run():
            ctx = DcnContext(_client(store, pid, 2), timeout_s=10.0)
            ck = coord.CoordinatedDeviceCheckpointer(
                DeviceOptimizerCheckpointer(str(tmp_path / f"p{pid}"), "bc"), ctx)
            return ck.load(_template(state), meta)
        return run

    loaded = _threads([host(0), host(1)])
    for pid in range(2):
        for a, b in zip(loaded[pid], state):
            np.testing.assert_array_equal(a, b)


def test_allgather_round_keys_are_garbage_collected():
    store = InProcessCoordStore()

    def host(pid):
        def run():
            ctx = DcnContext(_client(store, pid, 2), timeout_s=10.0)
            for _ in range(5):
                ctx.allgather_arrays("gc", np.ones(2))
        return run

    assert _threads([host(0), host(1)]) == {0: None, 1: None}
    assert len([k for k in store.kv if k.startswith("ag/gc/")]) <= 4


def test_coordinated_checkpointer_catches_diverged_host(tmp_path):
    from spark_gp_tpu_torch.utils.checkpoint import CheckpointMismatchError, LbfgsCheckpointer

    store, kernel = InProcessCoordStore(), tgp.RBFKernel(1.0)

    def host(pid):
        def run():
            ctx = DcnContext(_client(store, pid, 2), timeout_s=10.0)
            inner = LbfgsCheckpointer(str(tmp_path), kernel, tag="div", seed=0)
            coord.CoordinatedLbfgsCheckpointer(inner, ctx)(np.asarray([0.5 if pid == 0 else 0.75]))
        return run

    out = _threads([host(0), host(1)])
    assert isinstance(out[0], CheckpointMismatchError)
    assert isinstance(out[1], CheckpointMismatchError)
    assert "forked" in str(out[1])
    assert "[0]" in str(out[1]) and "[1]" in str(out[0])


# -- the store-mode fit, both packages ------------------------------------------------


def _half_rows(pid):
    rng = np.random.default_rng(100 + pid)
    n = 144 if pid == 0 else 112
    x = rng.normal(size=(n, 2))
    return x, np.sin(x.sum(axis=1)) + 0.01 * rng.normal(size=n)


def _gp(pkg=tgp, maxiter=50, ckpt_dir=None):
    kw = {"device": "cpu"} if pkg is tgp else {}
    gp = (pkg.GaussianProcessRegression(**kw).setKernel(lambda: pkg.RBFKernel(1.0))
          .setActiveSetSize(48).setMaxIter(maxiter).setTol(1e-10).setSeed(3))
    return gp if ckpt_dir is None else gp.setCheckpointDir(str(ckpt_dir))


def _local_stack(pid):
    x, y = _half_rows(pid)
    return group_for_experts(x, y, 16, dtype=torch.float64, device="cpu")


def _store_fit(pid, ctx, ckpt_dir=None, maxiter=50):
    def run():
        coord.set_dcn_context_for_testing(ctx)
        try:
            return _gp(tgp, maxiter, ckpt_dir).fit_distributed(_local_stack(pid))
        finally:
            coord.set_dcn_context_for_testing(None)
    return run


def _pair_ctxs(pkg=coord, timeout_s=30.0, ctx_cls=None):
    store = pkg.InProcessCoordStore()
    return [(ctx_cls or pkg.DcnContext)(_client(store, pid, 2, pkg=pkg), timeout_s=timeout_s)
            for pid in range(2)]


def _port_pair(ckpt_dir=None, maxiter=50, ctxs=None):
    ctxs = ctxs or _pair_ctxs()
    return _threads([_store_fit(pid, ctxs[pid], ckpt_dir, maxiter) for pid in range(2)])


def _jax_local_stack(pid):
    import jax

    from spark_gp_tpu.parallel.experts import group_for_experts as j_group
    from spark_gp_tpu.parallel.mesh import expert_mesh, shard_experts

    devs = jax.devices()
    half = max(1, len(devs) // 2)
    mesh = expert_mesh(devs[pid * half:(pid + 1) * half])
    x, y = _half_rows(pid)
    return shard_experts(j_group(x, y, 16), mesh), mesh


def _jax_pair(ckpt_dir=None, maxiter=50):
    ctxs = _pair_ctxs(jcoord)

    def fit(pid):
        def run():
            jcoord.set_dcn_context_for_testing(ctxs[pid])
            try:
                data, mesh = _jax_local_stack(pid)
                return _gp(jgp, maxiter, ckpt_dir).setMesh(mesh).fit_distributed(data)
            finally:
                jcoord.set_dcn_context_for_testing(None)
        return run

    return _threads([fit(0), fit(1)])


@pytest.fixture(scope="module")
def pair_fits():
    port, jax_ = _port_pair(), _jax_pair()
    for out in (port, jax_):
        for pid in range(2):
            assert not isinstance(out[pid], BaseException), out[pid]
    return port, jax_


def test_store_fit_two_ranks_lockstep_and_matches_jax(pair_fits):
    """Two logical ranks, unequal row blocks, every sum over the store:
    both end with the same model (bit-equal theta and predictions), the
    joint fit learns the function, and theta is the JAX package's DCN
    fit's to 1e-6 relative."""
    port, jax_ = pair_fits
    m0, m1 = port[0], port[1]
    np.testing.assert_array_equal(m0.raw_predictor.theta, m1.raw_predictor.theta)
    probe = np.random.default_rng(999).normal(size=(32, 2))
    np.testing.assert_array_equal(m0.predict(probe), m1.predict(probe))
    x0, y0 = _half_rows(0)
    assert float(np.sqrt(np.mean((m0.predict(x0) - y0) ** 2))) < 0.15
    np.testing.assert_allclose(m0.raw_predictor.theta, jax_[0].raw_predictor.theta, rtol=1e-6)


class _DyingCtx(DcnContext):
    """A rank that stops taking part after N objective rounds: its peer
    must meet the deadline, not hang."""

    def __init__(self, client, timeout_s=None, die_after_vag_rounds=10 ** 9):
        super().__init__(client, timeout_s=timeout_s)
        self.die_after = die_after_vag_rounds
        self._vag_rounds = 0

    def allgather_bytes(self, name, payload):
        if name == "vag":
            self._vag_rounds += 1
            if self._vag_rounds > self.die_after:
                raise chaos.SimulatedPreemption(f"rank died before vag round {self._vag_rounds}")
        return super().allgather_bytes(name, payload)


def _union_stack():
    from spark_gp_tpu_torch.parallel.experts import ExpertData

    parts = [_local_stack(pid) for pid in range(2)]
    return ExpertData(*(torch.cat([getattr(p, k) for p in parts]) for k in ("x", "y", "mask")))


def test_kill_one_rank_then_elastic_resume_on_different_process_count(pair_fits, tmp_path):
    """Rank 1 dies mid-fit; rank 0 raises a CoordinationTimeoutError naming
    it within the deadline, the coordinated checkpoint on disk; one process
    over the union of both blocks resumes from it (an elastic resume,
    counted once) and lands on the uninterrupted fit's theta to 1e-6."""
    store = InProcessCoordStore()
    ctxs = [DcnContext(_client(store, 0, 2), timeout_s=2.0),
            _DyingCtx(_client(store, 1, 2), timeout_s=2.0, die_after_vag_rounds=6)]
    t0 = time.monotonic()
    out = _port_pair(tmp_path, ctxs=ctxs)
    assert time.monotonic() - t0 < 20.0
    assert isinstance(out[1], chaos.SimulatedPreemption)
    assert isinstance(out[0], CoordinationTimeoutError) and out[0].missing == (1,)
    from spark_gp_tpu_torch.utils.checkpoint import load_checkpoint_payload

    payload = load_checkpoint_payload(str(tmp_path), tag="GaussianProcessRegression")
    assert payload["iteration"] >= 1 and payload["elastic"]["process_count"] == 2
    before = _counter("coord.elastic_resumes")
    resumed = _gp(tgp, ckpt_dir=tmp_path).fit_distributed(_union_stack())
    assert _counter("coord.elastic_resumes") == before + 1
    assert resumed.metrics["resumed_from_iteration"] >= 1
    np.testing.assert_allclose(resumed.raw_predictor.theta,
                               pair_fits[0][0].raw_predictor.theta, rtol=1e-6)


def test_checkpoints_cross_packages_elastically(pair_fits, tmp_path):
    """A coordinated host checkpoint written by two logical ranks of either
    package resumes in one process of the other, each counting one elastic
    resume, and converges to the uninterrupted two-rank fit's theta."""
    from spark_gp_tpu.obs.runtime import telemetry as j_telemetry
    from spark_gp_tpu.parallel.experts import ExpertData as JData
    from spark_gp_tpu.parallel.mesh import expert_mesh, shard_experts

    theta_ref = pair_fits[0][0].raw_predictor.theta
    # JAX writes (two ranks, three iterations), the port resumes alone
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    assert not any(isinstance(v, BaseException) for v in _jax_pair(j_dir, maxiter=3).values())
    before = _counter("coord.elastic_resumes")
    resumed = _gp(tgp, ckpt_dir=j_dir).fit_distributed(_union_stack())
    assert _counter("coord.elastic_resumes") == before + 1
    assert resumed.metrics["resumed_from_iteration"] == 3
    np.testing.assert_allclose(resumed.raw_predictor.theta, theta_ref, rtol=1e-5)
    # the port writes (two ranks), JAX resumes alone
    assert not any(isinstance(v, BaseException) for v in _port_pair(t_dir, maxiter=3).values())
    stacks = [_jax_local_stack(pid)[0] for pid in range(2)]
    union = JData(*(np.concatenate([np.asarray(getattr(s, k)) for s in stacks])
                    for k in ("x", "y", "mask")))
    j_before = j_telemetry.counters.get("coord.elastic_resumes", 0.0)
    j_resumed = _gp(jgp, ckpt_dir=t_dir).setMesh(expert_mesh()).fit_distributed(
        shard_experts(union, expert_mesh()))
    assert j_telemetry.counters.get("coord.elastic_resumes", 0.0) == j_before + 1
    assert j_resumed.instr.metrics["resumed_from_iteration"] == 3
    np.testing.assert_allclose(j_resumed.raw_predictor.theta, theta_ref, rtol=1e-5)


def _store_mesh_fit(ctx, ckpt_dir, maxiter):
    """``fit`` over a two-rank store mesh of rank 0's 144 rows: nine
    experts of 16, padded by one masked expert."""
    def run():
        coord.set_dcn_context_for_testing(ctx)
        try:
            return (_gp(tgp, maxiter, ckpt_dir).setDatasetSizeForExpert(16)
                    .setMesh(coord.store_mesh(ctx, "cpu")).fit(*_half_rows(0)))
        finally:
            coord.set_dcn_context_for_testing(None)
    return run


def test_an_odd_expert_count_resumes_two_ranks_to_one(tmp_path):
    """Nine experts over two ranks (one padded expert): the two-rank host
    checkpoint resumes in one process by replaying its log (an elastic
    resume, counted once) and ends at the one-process fit's theta to
    1e-6."""
    ctxs = _pair_ctxs()
    out = _threads([_store_mesh_fit(ctxs[pid], tmp_path, 3) for pid in range(2)])
    assert not any(isinstance(v, BaseException) for v in out.values()), out
    assert out[0].metrics["num_experts"] == 10
    before = _counter("coord.elastic_resumes")
    resumed = _gp(tgp, ckpt_dir=tmp_path).setDatasetSizeForExpert(16).fit(*_half_rows(0))
    assert _counter("coord.elastic_resumes") == before + 1
    assert resumed.metrics["resumed_from_iteration"] == 3
    assert resumed.metrics["lbfgs_nfev"] > 0
    alone = _gp(tgp).setDatasetSizeForExpert(16).fit(*_half_rows(0))
    np.testing.assert_allclose(resumed.raw_predictor.theta, alone.raw_predictor.theta,
                               rtol=1e-6)


def test_the_stack_fingerprint_leaves_the_padding_out():
    """``segment_meta`` of nine experts sharded over two ranks (a store
    mesh, one padded expert) is the unsharded stack's: nine experts and
    the same fingerprint to summation order; a padded stack of one rank
    keeps the fingerprint exactly, and other data does not match."""
    from spark_gp_tpu_torch.parallel.mesh import shard_experts
    from spark_gp_tpu_torch.utils.checkpoint import (
        SUMMATION_RTOL,
        fingerprints_match,
        segment_meta,
        stack_fingerprint,
    )

    whole = group_for_experts(*_half_rows(0), 16, dtype=torch.float64, device="cpu")
    kernel = _gp(tgp)._get_kernel()
    theta0 = kernel.init_theta()
    want = segment_meta("gpr", kernel, 1e-6, True, theta0, whole.x, whole.y, whole.mask)
    ctxs = _pair_ctxs()

    def meta(pid):
        def run():
            mesh = coord.store_mesh(ctxs[pid], "cpu")
            block = shard_experts(whole, mesh)
            return segment_meta("gpr", kernel, 1e-6, True, theta0, block.x, block.y,
                                block.mask, mesh=mesh)
        return run

    out = _threads([meta(0), meta(1)])
    for pid in range(2):
        got = out[pid]
        assert got["num_experts"] == want["num_experts"] == 9
        assert fingerprints_match(got.pop("data_fingerprint"), want["data_fingerprint"],
                                  SUMMATION_RTOL)
        assert got == {k: v for k, v in want.items() if k != "data_fingerprint"}
    padded = whole.pad_experts(2)
    assert stack_fingerprint(padded.x, padded.y, padded.mask) == \
        stack_fingerprint(whole.x, whole.y, whole.mask) == (want["data_fingerprint"], 9)
    other = stack_fingerprint(whole.x * 1.001, whole.y, whole.mask)[0]
    assert not fingerprints_match(other, want["data_fingerprint"], SUMMATION_RTOL)


@pytest.mark.parametrize("family", ["GaussianProcessClassifier",
                                    "GaussianProcessPoissonRegression"])
def test_latent_families_fit_in_the_store_mode(family):
    """The Laplace families' fit_distributed enters the same scope: each
    rank's Newton modes stay local, each evaluation's value and gradient
    are one vag round over the store, and both ranks end bit-equal."""
    ctxs = _pair_ctxs()

    def fit(pid):
        def run():
            x, y = _half_rows(pid)
            y = (y > 0).astype(float) if family == "GaussianProcessClassifier" \
                else np.round(np.exp(y))
            coord.set_dcn_context_for_testing(ctxs[pid])
            try:
                return (getattr(tgp, family)(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
                        .setActiveSetSize(24).setMaxIter(5).setSeed(3).fit_distributed(
                            group_for_experts(x, y, 16, dtype=torch.float64, device="cpu")))
            finally:
                coord.set_dcn_context_for_testing(None)
        return run

    out = _threads([fit(0), fit(1)])
    for pid in range(2):
        assert not isinstance(out[pid], BaseException), out[pid]
        assert ctxs[pid].gathers["vag"] >= out[pid].metrics["lbfgs_nfev"] >= 1
    np.testing.assert_array_equal(out[0].raw_predictor.theta, out[1].raw_predictor.theta)
    np.testing.assert_array_equal(out[0].raw_predictor.magic_vector,
                                  out[1].raw_predictor.magic_vector)


def test_distributed_ladder_takes_the_store_rung(pool):
    """Two real gloo ranks, the store mode off: a compile failure of the
    sharded attempt on both ranks re-runs the fit in the key-value-store
    mode (``dcn_fallback``, both ranks voting for it in one store round),
    which ends at the group-sharded fit's theta with the ranks bit-equal;
    a CoordinationTimeoutError is ``coord_timeout``."""
    from spark_gp_tpu_torch.resilience import fallback

    x, y, xt = _rows()
    group = pool.run("fit", spec=_SPEC, x=x, y=y, xt=xt, mode="distributed")
    out = pool.run("ladder_fit", spec=_SPEC, x=x, y=y, xt=xt)
    for r in range(2):
        theta, rungs, rounds = out[r]
        assert rungs == ["dcn_fallback"]
        assert rounds["agree/dcn_fallback"] >= 1 and rounds["vag"] >= 1
        np.testing.assert_allclose(theta, group[r][0], rtol=1e-10)
    np.testing.assert_array_equal(out[0][0], out[1][0])
    exc = CoordinationTimeoutError("allgather/vag/3", 5.0, [1])
    assert fallback.classify_failure(exc) == fallback.COORD_TIMEOUT


def test_plain_fit_checkpoints_stay_local_on_clusters(tmp_path):
    """A plain fit without a mesh keeps plain local writers even with a
    context bound: two independent fits never meet on the store."""
    store = InProcessCoordStore()
    coord.set_dcn_context_for_testing(DcnContext(_client(store, 0, 2), timeout_s=0.5))
    try:
        x, y = _half_rows(0)
        _gp(tgp, maxiter=3, ckpt_dir=tmp_path).fit(x, y)
    finally:
        coord.set_dcn_context_for_testing(None)
    assert (tmp_path / "lbfgs_state_GaussianProcessRegression.json").exists()
    assert not [k for k in store.kv if k.startswith("ag/")]


# -- preemption -----------------------------------------------------------------------


def test_staged_preemption_stops_fit_at_save_boundary(tmp_path):
    from spark_gp_tpu_torch.utils.checkpoint import load_checkpoint_payload

    x, y = _half_rows(0)
    before = _counter("coord.preemptions")
    try:
        chaos.stage_preemption(True)
        with pytest.raises(coord.PreemptedError):
            _gp(tgp, maxiter=30, ckpt_dir=tmp_path).fit(x, y)
    finally:
        chaos.stage_preemption(False)
        coord.clear_preemption_for_testing()
    assert _counter("coord.preemptions") == before + 1
    payload = load_checkpoint_payload(str(tmp_path), tag="GaussianProcessRegression")
    assert payload["iteration"] == 1
    resumed = _gp(tgp, maxiter=30, ckpt_dir=tmp_path).fit(x, y)
    clean = _gp(tgp, maxiter=30).fit(x, y)
    np.testing.assert_allclose(resumed.raw_predictor.theta, clean.raw_predictor.theta,
                               atol=1e-6)


def test_preemption_watcher_install_is_idempotent():
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert coord.install_preemption_watcher()
        assert coord.install_preemption_watcher()
        assert not coord.preemption_requested()
    finally:
        signal.signal(signal.SIGTERM, prev)
        coord._WATCHER_INSTALLED = False
        coord.clear_preemption_for_testing()


def test_preemption_watch_scoped_install_restore_and_consume():
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    with coord.preemption_watch():
        inside = signal.getsignal(signal.SIGTERM)
        assert inside is not prev
        inside(signal.SIGTERM, None)  # a delivery: the flag only
        assert coord.preemption_requested()
        coord.note_preemption_observed()
        coord.consume_preemption()
        assert not coord.preemption_requested()
    assert signal.getsignal(signal.SIGTERM) is prev
    coord.clear_preemption_for_testing()


def test_serve_drain_uses_the_shared_flag_handler():
    """The serve drain's handler is the coordination plane's factory (the
    two handlers stay one): it sets its flag and chains nothing."""
    import signal

    from spark_gp_tpu_torch.serve import lifecycle

    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        flag = lifecycle.install_drain_signals()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler.__qualname__ == coord.make_flag_handler(flag).__qualname__
        handler(signal.SIGTERM, None)
        assert flag.is_set()
    finally:
        for sig, h in saved.items():
            signal.signal(sig, h)


# -- two real gloo ranks over a FileStore -----------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = w.MeshPool(2, tmp_path_factory.mktemp("coord"))
    yield ranks
    ranks.close()


def _rows(n=160, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    return x, np.sin(x @ np.array([0.9, -0.5])) + 0.05 * rng.normal(size=n), rng.normal(size=(9, 2))


_SPEC = {"family": "gpr", "s": 20, "m_active": 16, "maxiter": 8}


def test_store_barrier_a_rank_skips_names_it_within_the_deadline(pool):
    out = pool.run("skipped_barrier", barrier_name="skip/0", skip=1, timeout_s=1.0)
    assert out[1] is None
    missing, seconds = out[0]
    assert missing == [1] and 1.0 <= seconds < 3.0


def test_store_fit_equals_the_group_sharded_fit_with_no_collective(pool):
    """The store mode's fit of each rank's block against the
    group-sharded fit of the same blocks: theta within 1e-10 relative (the
    same float64 sums, in rank order; bit-equal here), the ranks
    bit-equal, and not one process-group collective in the store fit."""
    x, y, xt = _rows()
    group = pool.run("fit", spec=_SPEC, x=x, y=y, xt=xt, mode="distributed")
    store = pool.run("store_fit", spec=_SPEC, x=x, y=y, xt=xt)
    for r in range(2):
        np.testing.assert_allclose(store[r][0], group[r][0], rtol=1e-10)
        np.testing.assert_array_equal(store[r][0], group[r][0])
        assert store[r][4] == 0, f"rank {r} made {store[r][4]} process-group collectives"
        assert store[r][5]["vag"] == int(store[r][3][0])  # one round an evaluation
    np.testing.assert_array_equal(store[0][0], store[1][0])
    np.testing.assert_array_equal(store[0][1], store[1][1])


def test_store_fit_runs_the_kmeans_provider_over_the_store(pool):
    """The k-means provider selects off the stack over the store mesh (a
    store round a Lloyd step) as it does over the process group: the
    store fit's active set and theta are the group fit's, with no
    process-group collective made."""
    spec = dict(_SPEC, provider="kmeans")
    x, y, xt = _rows()
    group = pool.run("fit", spec=spec, x=x, y=y, xt=xt, mode="distributed")
    store = pool.run("store_fit", spec=spec, x=x, y=y, xt=xt)
    for r in range(2):
        np.testing.assert_allclose(store[r][2], group[r][2], rtol=1e-10)
        np.testing.assert_allclose(store[r][0], group[r][0], rtol=1e-10)
        assert store[r][4] == 0, f"rank {r} made {store[r][4]} process-group collectives"
    np.testing.assert_array_equal(store[0][2], store[1][2])
    np.testing.assert_array_equal(store[0][0], store[1][0])


@pytest.mark.parametrize("optimizer", ["host", "device"])
def test_coordinated_checkpoint_preempted_on_one_rank_stops_both(pool, tmp_path, optimizer):
    """A checkpoint directory under a two-rank mesh (rank 0 writes, every
    rank checks the digest) while rank 1 stages a preemption: both ranks
    stop with PreemptedError at the same save, and the resume ends at the
    uninterrupted fit's theta.  ``device``: the CPU device loop's segments
    through the coordinated device shell."""
    x, y, _ = _rows()
    out = pool.run("preempted_checkpoint", spec=dict(_SPEC, maxiter=12), x=x, y=y,
                   directory=str(tmp_path), preempt_rank=1, optimizer=optimizer)
    for raised, saves, iteration, ref, resumed, done in out:
        assert raised == "PreemptedError"
        assert saves == out[0][1] >= 1
        assert done >= 1
        np.testing.assert_allclose(resumed, ref, rtol=1e-8)
    if optimizer == "host":
        assert out[0][2] == 1  # the first save is the last before the stop
    np.testing.assert_array_equal(out[0][4], out[1][4])


# -- the collective-guard lint -----------------------------------------------------------

_GUARD_EXEMPT = ("parallel/coord.py", "parallel/distributed.py")
_STORE_NAMES = {"Store", "FileStore", "TCPStore", "HashStore", "PrefixStore"}
_BARRIERS = {"barrier", "monitored_barrier"}


def _guard_violations(root):
    """``(path, line, what)`` for every use of a ``torch.distributed`` store
    or barrier outside the coordination plane's two modules under
    ``root``: the port's counterpart of ``tools/check_collective_guards.py``.
    The mesh's and the sharded solve's collectives (``parallel/mesh.py``,
    ``ops/dist_linalg.py``) are the algorithm's, as XLA's psums are exempt
    in the JAX package."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if not name.endswith(".py") or rel in _GUARD_EXEMPT:
                continue
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and (
                        node.attr in _STORE_NAMES or node.attr in _BARRIERS):
                    base = ast.unparse(node.value)
                    if base in ("dist", "torch.distributed", "c10d") or base.endswith(".distributed"):
                        out.append((rel, node.lineno, f"{base}.{node.attr}"))
                elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                        "torch.distributed"):
                    for alias in node.names:
                        if alias.name in _STORE_NAMES | _BARRIERS:
                            out.append((rel, node.lineno, f"from {node.module} import {alias.name}"))
    return out


def test_collective_guard_lint_is_clean():
    root = os.path.dirname(os.path.abspath(tgp.__file__))
    assert _guard_violations(root) == []


def test_collective_guard_lint_catches_raw_calls(tmp_path):
    bad = tmp_path / "pkg" / "models" / "x.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(
        "import torch.distributed as dist\n"
        "from torch.distributed import FileStore\n"
        "def f(path):\n"
        "    dist.barrier()\n"
        "    return dist.TCPStore('localhost', 1, 2, True)\n"
        "def g(t):\n"
        "    dist.all_reduce(t)\n")
    exempt = tmp_path / "pkg" / "parallel" / "coord.py"
    exempt.parent.mkdir()
    exempt.write_text("import torch.distributed as dist\ndist.barrier()\n")
    flagged = {what for _, _, what in _guard_violations(str(tmp_path / "pkg"))}
    assert flagged == {"from torch.distributed import FileStore", "dist.barrier",
                       "dist.TCPStore"}
