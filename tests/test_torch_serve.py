"""The port's serving plane on the CPU (``serve/``): the server answers
bit-equal to its own bucketed predictor, sheds with the JAX package's
codes (draining, backpressure, deadline on an injected clock, memory),
its breaker opens on a failing predictor, the hang watchdog fails a
wedged model's batch with ``exec.hung`` while another model answers, and
canaries promote and roll back.  No test waits on a wall-clock race:
events, the injected clock and timeouts of seconds."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import ast
import threading
from pathlib import Path

import numpy as np
import pytest

import spark_gp_tpu_torch as tgp
from spark_gp_tpu_torch.obs.names import check_package
from spark_gp_tpu_torch.resilience import chaos
from spark_gp_tpu_torch.resilience.breaker import BreakerOpenError, CircuitBreaker
from spark_gp_tpu_torch.serve import (
    BucketedPredictor,
    CanaryPolicy,
    DeadlineExpiredError,
    DrainingError,
    ExecHungError,
    GPServeServer,
    MemoryAdmissionGate,
    MemoryPressureError,
    QueueFullError,
)
from spark_gp_tpu_torch.serve import codes
from spark_gp_tpu_torch.serve.lifecycle import MIXED_GUARD_BAR, HangWatchdog
from spark_gp_tpu_torch.utils.serialization import load_model

PACKAGE = Path(__file__).resolve().parent.parent / "spark_gp_tpu_torch"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Two fitted models on disk, and the first one's rows."""
    d = tmp_path_factory.mktemp("models")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 3))
    y = np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=200)
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
          .setDatasetSizeForExpert(40).setActiveSetSize(40).setMaxIter(8).setSeed(5))
    gp.fit(x, y).save(str(d / "a.npz"))
    gp.fit(x, 3.0 * y).save(str(d / "b.npz"))  # answers far from a's
    return {"a": str(d / "a.npz"), "b": str(d / "b.npz"), "x": x}


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _server(**kw):
    kw.setdefault("max_batch", 32)
    kw.setdefault("device", "cpu")
    return GPServeServer(**kw)


def test_answers_are_bit_equal_to_the_bucketed_predictor(saved):
    x = saved["x"]
    server = _server()
    server.register("a", saved["a"])
    server.start()
    try:
        bp = BucketedPredictor(load_model(saved["a"], device="cpu").raw_predictor, max_batch=32)
        for t in (1, 5, 8, 17, 32, 70):
            mean, var = server.predict("a", x[:t])
            bm, bv = bp.predict(x[:t])
            assert np.array_equal(mean, bm) and np.array_equal(var, bv)
        # concurrent submits coalesce; each answer is its own rows'
        futures = [server.submit("a", x[i:i + 3]) for i in range(0, 30, 3)]
        for i, fut in zip(range(0, 30, 3), futures):
            mean, _ = fut.result(timeout=30)
            np.testing.assert_allclose(mean, bp.predict(x[i:i + 3])[0], rtol=1e-12)
        entry = server.registry.get("a")
        assert entry.predictor.compile_counts == {8: 1, 16: 1, 32: 1}
        assert server.metrics.counter("compiles") == 3
        assert server.health()["status"] == "ok"
        page = server.openmetrics()
        assert "gp_request_latency_seconds_bucket" in page and 'gp_breaker_open{model="a"} 0' in page
        assert page.endswith("# EOF\n")
        snap = server.snapshot()
        assert snap["queue"]["capacity"] == 1024
        assert snap["models"][0]["compiles"] == {8: 1, 16: 1, 32: 1}
    finally:
        server.stop()
    assert check_package() == []


def test_shed_codes_draining_backpressure_deadline(saved):
    x = saved["x"]
    clock = FakeClock()
    server = _server(capacity=2, clock=clock)
    server.register("a", saved["a"])
    # not started: requests stay queued, so capacity and deadlines act
    late = server.submit("a", x[:2], timeout_ms=50.0)
    server.submit("a", x[:2], timeout_ms=10_000.0)
    with pytest.raises(QueueFullError) as full:
        server.submit("a", x[:2])
    assert full.value.code == "queue.shed.backpressure"
    clock.t += 1.0  # past the first request's deadline, not the second's
    server.start()
    with pytest.raises(DeadlineExpiredError) as expired:
        late.result(timeout=30)
    assert expired.value.code == "queue.shed.deadline"
    assert server.metrics.counter("queue.shed.deadline") == 1
    server.begin_drain()
    with pytest.raises(DrainingError) as draining:
        server.submit("a", x[:2])
    assert draining.value.code == "queue.shed.draining"
    assert server.health()["status"] == "draining"
    assert server.drain(5.0) is True
    counters = server.health()["counters"]
    assert counters["queue.shed.backpressure"] == 1 and counters["queue.shed.draining"] == 1
    for code in ("queue.shed.backpressure", "queue.shed.deadline", "queue.shed.draining"):
        assert codes.is_registered(code)


def test_breaker_opens_after_the_flaky_predictor_fails(saved):
    x = saved["x"]
    server = _server(breaker_threshold=2, breaker_reset_s=600.0)
    server.register("a", saved["a"])
    server.start()
    try:
        flaky = chaos.break_model(server, "a", fail_forever=True)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="injected predict failure"):
                server.predict("a", x[:3])
        with pytest.raises(BreakerOpenError) as info:
            server.predict("a", x[:3])
        assert info.value.code == "shed.breaker"
        assert flaky.calls == 2  # the open breaker rejected without a dispatch
        health = server.health()
        assert health["status"] == "degraded" and health["broken_models"] == ["a"]
        assert server.metrics.counter("breaker.trips") == 1
    finally:
        server.stop()


def test_breaker_half_open_probe_on_an_injected_clock():
    clock = FakeClock()
    breaker = CircuitBreaker("m", failure_threshold=1, reset_timeout_s=5.0, clock=clock)
    breaker.record_failure()
    with pytest.raises(BreakerOpenError):
        breaker.before_call()
    clock.t += 5.0
    assert breaker.state == CircuitBreaker.HALF_OPEN
    breaker.before_call()          # the one probe
    with pytest.raises(BreakerOpenError):
        breaker.before_call()      # a second caller waits for it
    breaker.record_success()
    assert breaker.state == CircuitBreaker.CLOSED and breaker.trip_count == 1


def test_hang_watchdog_fails_the_wedged_model_while_another_answers(saved):
    x = saved["x"]
    server = _server(hang_timeout_s=0.5, breaker_reset_s=600.0)
    server.register("a", saved["a"])
    server.register("b", saved["b"])
    server.start()
    hanging = chaos.hang_model(server, "a", hang_forever=True)
    try:
        wedged = server.submit("a", x[:4])
        assert hanging.entered.wait(30)
        with pytest.raises(ExecHungError) as info:
            wedged.result(timeout=30)
        assert info.value.code == "exec.hung"
        mean, _ = server.predict("b", x[:4])  # the replaced worker serves b
        assert mean.shape == (4,)
        with pytest.raises(BreakerOpenError):
            server.submit("a", x[:4])
        assert server.metrics.counter("exec.hung") == 1
        assert server.health()["broken_models"] == ["a"]
    finally:
        hanging.release()
        server.stop()


def test_watchdog_verdict_on_an_injected_clock():
    clock = FakeClock()
    fired = []
    dog = HangWatchdog(fired.append, hang_timeout_s=5.0, poll_interval_s=0.005, clock=clock)
    token = dog.begin("m", [])
    dog.start()
    try:
        clock.t += 6.0
        for _ in range(2000):
            if fired:
                break
            threading.Event().wait(0.005)
        assert fired == [token] and token.fired and dog.trips == 1
    finally:
        dog.stop()


def test_canary_promotes_and_rolls_back(saved):
    x = saved["x"]
    server = _server()
    server.register("a", saved["a"])
    server.start()
    try:
        # the same file as a candidate: zero shadow delta, promoted
        entry = server.register("a", saved["a"],
                                canary_policy=CanaryPolicy(fraction=1.0, promote_after=2))
        assert entry.version == 2 and server.registry.get("a").version == 1
        for _ in range(2):
            server.predict("a", x[:5])
        assert server.registry.get("a").version == 2
        assert server.metrics.counter("canary.promotions") == 1
        # a candidate answering far from the incumbent: rolled back
        bad = server.rollout("a", saved["b"], canary_policy=CanaryPolicy(fraction=1.0))
        server.predict("a", x[:5])
        assert server.registry.get("a").version == 2
        assert server.canaries.is_quarantined("a", bad.version)
        assert server.metrics.counter("canary.rollbacks") == 1
        assert CanaryPolicy().delta_predict_bar == MIXED_GUARD_BAR == 1e-2
    finally:
        server.stop()


def test_memory_gate_sheds_under_a_staged_sampler(saved):
    samples = iter([100.0, 950.0, 950.0, 800.0, 100.0, 100.0])
    clock = FakeClock()
    gate = MemoryAdmissionGate(limit_bytes=1000.0, sample_interval_s=0.0, clock=clock,
                               sampler=lambda: next(samples))
    gate.check()                                   # 100: admitted
    with pytest.raises(MemoryPressureError) as info:
        gate.check()                               # 950: over the high watermark
    assert info.value.code == "queue.shed.memory"
    gate.check(priority=1)                         # at the floor: admitted
    with pytest.raises(MemoryPressureError):
        gate.check()                               # 800: hysteresis holds
    gate.check()                                   # 100: recovered
    with pytest.raises(MemoryPressureError, match="predicted"):
        gate.check(predicted_bytes=5000.0)         # over the headroom alone
    assert gate.snapshot()["plan_sheds"] == 1

    server = _server(memory_limit_bytes=1000.0)
    server.memory_gate = MemoryAdmissionGate(limit_bytes=1000.0, sample_interval_s=0.0,
                                             sampler=lambda: 990.0)
    server.register("a", saved["a"])
    with pytest.raises(MemoryPressureError):
        server.submit("a", saved["x"][:3])
    assert server.metrics.counter("queue.shed.memory") == 1


def test_registry_trims_and_releases_old_versions(saved):
    server = _server(max_versions=2)
    first = server.register("a", saved["a"])
    for _ in range(2):
        server.reload("a")
    assert [m["version"] for m in server.registry.describe()] == [2, 3]
    assert first.predictor.released
    assert server.metrics.counter("registry.evictions") == 1


def test_refusals(saved):
    server = _server()
    server.register("a", saved["a"])
    bad = saved["x"][:3].copy()
    bad[1, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        server.submit("a", bad)
    with pytest.raises(ValueError, match=r"\[t, 3\]"):
        server.submit("a", saved["x"][:3, :2])
    with pytest.raises(KeyError):
        server.submit("nope", saved["x"][:3])
    from spark_gp_tpu_torch.obs.quality import QualityDisabledError, UnknownRequestError

    # the quality plane (on by default) refuses an id it never served,
    # and a server with it off refuses observe, each with its wire code
    with pytest.raises(UnknownRequestError) as info:
        server.observe("a", "request", [0.0])
    assert info.value.code == "observe.unknown_request"
    with pytest.raises(QualityDisabledError) as info:
        _server(quality=False).observe("a", "request", [0.0])
    assert info.value.code == "observe.disabled"


def _emitted_codes():
    """Every ``code`` the package can put on the wire: class attributes
    ``code = "..."``, ``"code": "..."`` literals and ``ARTIFACT_DIGEST_CODE``."""
    found = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in ("code", "ARTIFACT_DIGEST_CODE")
                    for t in node.targets) and isinstance(node.value, ast.Constant):
                found.add(node.value.value)
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "code" \
                            and isinstance(v, ast.Constant):
                        found.add(v.value)
    return found


def test_every_emitted_code_is_catalogued():
    emitted = _emitted_codes()
    assert {"exec.hung", "shed.breaker", "queue.shed.memory",
            "model_sidecar_digest_mismatch", "serve.conn_limit"} <= emitted
    for code in emitted:
        assert codes.grammar_ok(code) and codes.is_registered(code), code
