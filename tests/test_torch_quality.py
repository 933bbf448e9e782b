"""The statistical quality plane (ROADMAP.md item 10b) against the JAX
package: the same seeded streams through both packages' monitors give
equal snapshots (the port's ``obs/quality.py`` is the same numpy code, so
floats agree to 1e-12 relative), the fit-time expert-quality probe agrees
with the JAX package's (per-expert NLL 1e-9 relative, float64), the
covariate summary crosses packages through ``save`` / ``load`` both ways,
and the server's ``observe``, health, chaos faults and canary veto behave
as ``tests/test_quality_obs.py`` holds the JAX server to, at small size."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.obs import quality as jq
from spark_gp_tpu_torch.obs import quality as tq
from spark_gp_tpu_torch.parallel.experts import group_for_experts
from spark_gp_tpu_torch.resilience import chaos
from spark_gp_tpu_torch.serve import GPServeServer
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation

#: the JAX package's acceptance bound (tests/test_quality_obs.py):
#: injected faults alert within this many observations, a clean twin never
ALERT_BUDGET = 512
#: the two packages run the same numpy code on the same stream
REL = 1e-12


def _stream(rng, n, sigma_truth_factor=1.0, bias=0.0):
    mean = rng.normal(size=n)
    sigma = np.abs(rng.normal(1.0, 0.3, size=n)) + 0.2
    y = mean + bias + sigma_truth_factor * sigma * rng.standard_normal(n)
    return mean, sigma ** 2, y


def _same(a, b, path="snapshot"):
    """Equal nested snapshots: floats to :data:`REL`, the rest exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= REL * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("factor,bias", [(1.0, 0.0), (2.0, 0.0), (1.0, 1.5), (0.5, 0.0)])
def test_quality_monitor_snapshots_match_jax(factor, bias):
    monitors = [pkg.QualityMonitor(window=64) for pkg in (jq, tq)]
    verdicts = [[], []]
    rng = np.random.default_rng(11)
    for _ in range(13):
        mean, var, y = _stream(rng, int(rng.integers(5, 40)), factor, bias)
        for i, mon in enumerate(monitors):
            verdicts[i] += mon.observe(mean, var, y)
    _same(monitors[0].snapshot(), monitors[1].snapshot())
    _same(verdicts[0], verdicts[1], "verdicts")
    assert monitors[1].windows_closed >= 3
    assert monitors[1].alert == (factor != 1.0 or bias != 0.0)


@pytest.mark.parametrize("shift", [0.0, 4.0])
def test_covariate_summary_and_drift_monitor_match_jax(shift):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5000, 3)) * [1.0, 2.0, 0.5]
    active = x[rng.choice(5000, size=40, replace=False)]
    summaries = [pkg.summarize_covariates(x, active=active, seed=3) for pkg in (jq, tq)]
    _same(summaries[0], summaries[1], "summary")
    drifts = [pkg.DriftMonitor(s, window=32) for pkg, s in zip((jq, tq), summaries)]
    closed = [[], []]
    for _ in range(20):
        rows = rng.normal(size=(int(rng.integers(4, 60)), 3)) + shift * np.std(x)
        for i, d in enumerate(drifts):
            closed[i] += d.score_rows(rows)
    _same(drifts[0].snapshot(), drifts[1].snapshot(), "drift")
    _same(closed[0], closed[1], "windows")
    assert drifts[1].alert == (shift > 0)
    for pkg in (jq, tq):
        assert pkg.summarize_covariates(np.ones((1, 2))) is None


def test_pending_ring_matches_jax():
    rings = [pkg.PendingRing(capacity=3) for pkg in (jq, tq)]
    for ring, pkg in zip(rings, (jq, tq)):
        for i in range(5):
            ring.put(f"r{i}", np.full(2, float(i)), np.ones(2))
        assert ring.evicted == 2 and ring.depth() == 3
        with pytest.raises(ValueError):
            ring.join("r3", expect_rows=1)   # not consumed
        mean, var = ring.join("r3", expect_rows=2)
        assert mean.tolist() == [3.0, 3.0]
        assert ring.join("r3") is None       # idempotent duplicate
        with pytest.raises(pkg.UnknownRequestError) as info:
            ring.join("r0")                  # evicted
        assert info.value.code == "observe.unknown_request"
    assert rings[0].depth() == rings[1].depth() == 2


# -- the fit side ----------------------------------------------------------


def _regression(m, seed=3, device=None):
    kw = {} if device is None else {"device": device}
    return (m.GaussianProcessRegression(**kw).setKernel(lambda: m.RBFKernel(1.0))
            .setDatasetSizeForExpert(40).setActiveSetSize(40).setSigma2(1e-3)
            .setMaxIter(5).setSeed(seed))


def _data(seed=3, n=160):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    return x, np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=n)


@pytest.fixture(scope="module")
def jax_fit():
    x, y = _data()
    return _regression(jgp).fit(x, y), x, y


def test_expert_quality_matches_jax(jax_fit):
    """The port's probe at the JAX fit's theta on the same stack (float64):
    per-expert NLL within 1e-9 relative, the same weights and jitter."""
    jmodel, x, y = jax_fit
    j_eq = jmodel.run_journal["expert_quality"]
    est = _regression(tgp, device="cpu")
    data = group_for_experts(x, y, 40, dtype=torch.float64, device="cpu")
    instr = Instrumentation(name="probe")
    est._emit_expert_quality(instr, est._get_kernel(), jmodel.raw_predictor.theta, data)
    t_eq = instr.expert_quality
    np.testing.assert_allclose(t_eq["nll"], j_eq["nll"], rtol=1e-9)
    for key in ("objective", "experts", "active", "jitter", "weight", "truncated"):
        assert t_eq[key] == j_eq[key], key
    for key in ("expert_quality.nll_spread", "expert_quality.nll_std",
                "expert_quality.jitter_max", "expert_quality.weight_min"):
        np.testing.assert_allclose(instr.metrics[key], jmodel.instr.metrics[key],
                                   rtol=1e-8, atol=1e-12)


def test_fit_stamps_expert_quality_and_the_kill_switch(monkeypatch):
    x, y = _data(seed=5)
    model = _regression(tgp, seed=5, device="cpu").fit(x, y)
    eq = model.run_journal["expert_quality"]
    assert eq["experts"] == 4 and eq["active"] == 4 and len(eq["nll"]) == 4
    assert all(np.isfinite(eq["nll"])) and eq["weight"] == [1.0] * 4
    assert model.metrics["expert_quality.weight_min"] == 1.0
    # one batched pass: on the CPU the plain branch launches nothing
    assert not any(k.startswith("expert_quality.probe_launches") for k in model.metrics)
    monkeypatch.setenv("GP_EXPERT_TELEMETRY", "0")
    monkeypatch.setenv("GP_COVARIATE_SUMMARY", "0")
    off = _regression(tgp, seed=5, device="cpu").fit(x, y)
    assert off.instr.expert_quality is None and off.instr.covariate_summary is None
    assert off.run_journal["expert_quality"] is None
    np.testing.assert_array_equal(off.raw_predictor.theta, model.raw_predictor.theta)


def test_probe_is_one_pass_per_lane(monkeypatch):
    """``expert_nll`` evaluates the whole stack once, unreduced, with no
    gradient, and equals the per-expert loop of ``expert_health``."""
    from spark_gp_tpu_torch.models import likelihood
    from spark_gp_tpu_torch.resilience.quarantine import expert_health, expert_nll

    x, y = _data(seed=7)
    est = _regression(tgp, device="cpu")
    kernel = est._get_kernel()
    data = group_for_experts(x, y, 40, dtype=torch.float64, device="cpu")
    theta = kernel.init_theta()
    calls = []
    real = likelihood.batched_nll

    def counted(*a, **kw):
        calls.append(kw.get("reduce", True))
        return real(*a, **kw)

    monkeypatch.setattr(likelihood, "batched_nll", counted)
    nll = expert_nll(kernel, theta, data, jitter=np.full(4, 1e-6))
    assert calls == [False]
    ref, _ = expert_health(kernel, theta, data, jitter=1e-6)
    np.testing.assert_allclose(nll, ref, rtol=1e-10)


def test_covariate_summary_crosses_packages_both_ways(tmp_path, jax_fit):
    jmodel, x, y = jax_fit
    jmodel.save(str(tmp_path / "jax.npz"))
    back = tgp.GaussianProcessRegressionModel.load(str(tmp_path / "jax.npz"), device="cpu")
    assert back.covariate_summary == jmodel.instr.covariate_summary
    tmodel = _regression(tgp, device="cpu").fit(x, y)
    tmodel.save(str(tmp_path / "port.npz"))
    from spark_gp_tpu.utils.serialization import load_model as j_load

    jback = j_load(str(tmp_path / "port.npz"))
    assert jback.covariate_summary == tmodel.instr.covariate_summary
    _same(tmodel.instr.covariate_summary, jmodel.instr.covariate_summary, "summary")


# -- the serve side --------------------------------------------------------


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    x, y = _data()
    model = _regression(tgp, device="cpu").fit(x, y)
    path = str(tmp_path_factory.mktemp("quality") / "model.npz")
    model.save(path)
    return path, model, x, y


def _boot(path, **kw):
    server = GPServeServer(max_batch=32, min_bucket=8, max_wait_ms=1.0,
                           request_timeout_ms=10_000.0, device="cpu", **kw)
    server.register("m", path)
    server.start()
    return server


def test_observe_joins_labels_and_health_carries_snapshot(saved_model):
    path, model, x, y = saved_model
    server = _boot(path, quality_window=32)
    try:
        server.submit("m", x[:4], request_id="r1").result(10.0)
        with pytest.raises(ValueError, match="4 row"):
            server.observe("m", "r1", y[:3])
        out = server.observe("m", "r1", y[:4])
        assert out["joined"] == 4 and out["duplicate"] is False
        dup = server.observe("m", "r1", y[:4])
        assert dup["joined"] == 0 and dup["duplicate"] is True
        assert server.metrics.counter("quality.observe.duplicate") == 1
        with pytest.raises(tq.UnknownRequestError):
            server.observe("m", "never-served", y[:1])
        assert server.metrics.counter("quality.observe.unknown_request") == 1
        health = server.health()
        assert health["quality"]["models"]["m"]["calibration"]["observations"] == 4
        assert health["quality"]["models"]["m"]["pending"]["depth"] == 0
        server.submit("m", x[:2]).result(10.0)   # no id: never parked
        assert server.quality.snapshot()["models"]["m"]["pending"]["depth"] == 0
        page = server.openmetrics()
        assert 'gp_quality_z_mean{model="m"}' in page and "gp_quality_observations_total" in page
    finally:
        server.stop()
    assert not server.quality._worker.is_alive()   # close() joined the drainer


def test_miscalibration_alerts_within_budget_and_degrades(saved_model):
    path, model, x, y = saved_model
    rng = np.random.default_rng(17)
    server = _boot(path, quality_window=64)

    def feed(n_obs, factor):
        done = i = 0
        while done < n_obs:
            rid = f"f{factor}-{i}"
            i += 1
            row = int(rng.integers(0, x.shape[0] - 8))
            mean, var = server.submit("m", x[row:row + 4], request_id=rid).result(10.0)
            server.observe("m", rid, mean + factor * np.sqrt(var) * rng.standard_normal(4))
            done += 4
            if server.health()["quality"]["alerting"]:
                return done
        return 0

    try:
        assert feed(ALERT_BUDGET, 1.0) == 0, "clean twin alerted"
        assert server.health()["status"] == "ok"
        with chaos.miscalibrate(0.5):
            tripped = feed(ALERT_BUDGET, 2.0)
        assert 0 < tripped <= ALERT_BUDGET
        assert server.health()["status"] == "degraded"
        assert server.metrics.counter("quality.alerts") >= 1
        assert server.metrics.gauges.get("quality.alert.m") == 1.0
    finally:
        server.stop()


def test_drift_inputs_alert_within_budget(saved_model):
    path, model, x, y = saved_model
    server = _boot(path)

    def pump(n_rows):
        done = 0
        while done < n_rows:
            row = done % (x.shape[0] - 8)
            server.submit("m", x[row:row + 8]).result(10.0)
            done += 8
            if server.health()["quality"]["alerting"]:
                return done
        return 0

    try:
        assert pump(ALERT_BUDGET) == 0, "clean traffic raised a drift alert"
        with chaos.drift_inputs(4.0 * float(x.std())):
            tripped = pump(ALERT_BUDGET)
        assert 0 < tripped <= ALERT_BUDGET
        assert server.metrics.counter("drift.alerts") >= 1
        assert server.metrics.gauges.get("drift.alert.m") == 1.0
        assert server.health()["status"] == "degraded"
    finally:
        server.stop()


def test_canary_quality_guard_vetoes_promotion(saved_model):
    from spark_gp_tpu_torch.serve.lifecycle import CanaryPolicy

    path, model, x, y = saved_model
    rng = np.random.default_rng(23)
    server = _boot(path, quality_window=32)
    try:
        for i in range(40):
            rid = f"g{i}"
            row = int(rng.integers(0, x.shape[0] - 8))
            mean, var = server.submit("m", x[row:row + 4], request_id=rid).result(10.0)
            server.observe("m", rid, mean + 3.0 * np.sqrt(var) * rng.standard_normal(4))
        assert server.quality.alert_reason("m") is not None
        server.register("m", path, canary_policy=CanaryPolicy(
            fraction=1.0, promote_after=3, quality_guard=True))
        for i in range(8):
            server.submit("m", x[i:i + 2]).result(10.0)
            if server.canaries.active("m") is None:
                break
        assert server.metrics.counter("canary.rollbacks") == 1
        assert server.metrics.counter("canary.promotions") == 0
        quarantined = server.canaries.snapshot()["quarantined"]
        assert any("quality alert" in r for r in quarantined.values()), quarantined
    finally:
        server.stop()


def test_quality_disabled_server_rejects_observe(saved_model, monkeypatch):
    path, model, x, y = saved_model
    monkeypatch.setenv("GP_SERVE_QUALITY", "0")
    server = _boot(path)
    try:
        assert server.quality is None
        server.submit("m", x[:2], request_id="r1").result(10.0)
        with pytest.raises(tq.QualityDisabledError) as err:
            server.observe("m", "r1", y[:2])
        assert err.value.code == "observe.disabled"
        assert server.health()["quality"] == {"enabled": False}
    finally:
        server.stop()
