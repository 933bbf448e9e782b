"""The port's degradation ladder (``resilience/fallback.py``) against the
JAX package's, float64 on the CPU.  Held exactly: the taxonomy and the
fit and predict ladders; the class of each exception in a table of
counterparts; the rung history ``(entry, class, from, to)`` of a fit
under ``oom_after_calls(0, op="fit.host")`` (800 rows, expert 50,
maxiter 3, the JAX side on its host optimizer).  The port's kernel
failures are ``unknown`` whatever their text, and a fit whose K1 wrapper
raises propagates it raw.  A staged memory limit between each package's
own iterative and native predictions (one expert of 800 rows, where the
port's iterative model sits below its native one; the JAX side on its
device optimizer with planning off -- its host path has no byte model --
and its clean fit on the host optimizer) ends each fit after one
``native -> iterative`` transition, its
``final_nll`` within 1e-2 relative of its clean fit's and the other
package's; the same limit under the caller's ``solver_lane_scope("exact")``
ends on ``iterative`` too.  The predict ladder's halvings, and its last
rung, give predictions within 1e-12 of the clean predict.  A precision
guard breach (the mixed lane's bar forced below 0) under
``GP_GUARD_ACTION=degrade`` takes one ``native -> strict_lane``
transition in both packages and ends at the strict fit's theta bit for
bit; under ``log`` it only warns; ``GP_GUARD_ACTION`` is validated with
the JAX package's message."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.ops.linalg import NotPositiveDefiniteException as JNotPD
from spark_gp_tpu.resilience import chaos as j_chaos
from spark_gp_tpu.resilience import fallback as j_fallback
from spark_gp_tpu.resilience import memplan as j_memplan
from spark_gp_tpu.resilience import quarantine as j_quarantine
from spark_gp_tpu.resilience.retry import RetryBudgetExceededError as JRetryExceeded
from spark_gp_tpu_torch.models import likelihood
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.ops.cuda_lib import KernelBuildError, KernelLaunchError
from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException
from spark_gp_tpu_torch.parallel.experts import group_for_experts
from spark_gp_tpu_torch.resilience import chaos, fallback, memplan, quarantine
from spark_gp_tpu_torch.resilience.retry import RetryBudgetExceededError


def _data(n=800):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3))
    return x, np.sin(x.sum(1))


def _gp(pkg, expert=50, optimizer="host", **kw):
    gp = (pkg.GaussianProcessRegression(**kw).setKernel(lambda: pkg.RBFKernel(1.0))
          .setDatasetSizeForExpert(expert).setActiveSetSize(50).setMaxIter(3))
    return gp.setOptimizer(optimizer) if pkg is jgp else gp


def test_taxonomy_and_ladders_match_jax():
    assert fallback.FAILURE_CLASSES == j_fallback.FAILURE_CLASSES
    assert fallback.LADDERS["fit"] == j_fallback.LADDERS["fit"]
    assert fallback.LADDERS["predict"] == j_fallback.LADDERS["predict"]
    assert fallback._FIT_POLICY == j_fallback._FIT_POLICY
    assert fallback.MAX_PREDICT_HALVINGS == j_fallback.MAX_PREDICT_HALVINGS


def _chained(cause_cls, cause_msg, wrapper):
    err = wrapper("retry budget exhausted")
    err.__cause__ = cause_cls(cause_msg)
    return err


#: (port exception, JAX counterpart) pairs
COUNTERPARTS = [
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     lambda: j_chaos._xla_runtime_error("RESOURCE_EXHAUSTED: Out of memory allocating")),
    (lambda: MemoryError(), lambda: MemoryError()),
    (lambda: RuntimeError("out of memory while staging"),
     lambda: RuntimeError("out of memory while staging")),
    (lambda: RuntimeError("INTERNAL: during compilation: boom"),
     lambda: j_chaos._xla_runtime_error("INTERNAL: during compilation: boom")),
    (lambda: RuntimeError("failed to compile the program"),
     lambda: RuntimeError("failed to compile the program")),
    (lambda: NotPositiveDefiniteException(), lambda: JNotPD()),
    (lambda: quarantine.NonFiniteFitError("nan"), lambda: j_quarantine.NonFiniteFitError("nan")),
    (lambda: quarantine.ExpertQuarantineError("all"),
     lambda: j_quarantine.ExpertQuarantineError("all")),
    (lambda: _chained(torch.cuda.OutOfMemoryError, "CUDA out of memory.", RetryBudgetExceededError),
     lambda: _chained(MemoryError, "", JRetryExceeded)),
    (lambda: fallback.GuardBreachError("mixed", 1e-2, 1e-3),
     lambda: j_fallback.GuardBreachError("mixed", 1e-2, 1e-3)),
    (lambda: fallback.DegradationExhaustedError("fit", "compile", [], ValueError()),
     lambda: j_fallback.DegradationExhaustedError("fit", "compile", [], ValueError())),
    (lambda: RuntimeError("CUDA error: an illegal memory access"),
     lambda: j_chaos._xla_runtime_error("INTERNAL: an illegal memory access")),
    (lambda: ValueError("out of memory"), lambda: ValueError("out of memory")),
    (lambda: KeyError("x"), lambda: KeyError("x")),
]


@pytest.mark.parametrize("case", range(len(COUNTERPARTS)))
def test_classification_agrees_with_jax(case):
    port, jax_side = COUNTERPARTS[case]
    cls = fallback.classify_failure(port())
    assert cls == j_fallback.classify_failure(jax_side())
    assert cls in fallback.FAILURE_CLASSES


def test_kernel_failures_are_unknown_whatever_their_text():
    text = "nvcc: failed to compile; ptxas: out of memory; compile failed; RESOURCE_EXHAUSTED"
    assert fallback.classify_failure(KernelBuildError(text)) == fallback.UNKNOWN
    assert fallback.classify_failure(KernelLaunchError("CUDA error 2: out of memory")) == "unknown"
    assert isinstance(KernelBuildError(text), RuntimeError)
    # the same text in a plain RuntimeError would degrade
    assert fallback.classify_failure(RuntimeError(text)) == fallback.OOM


def test_a_kernel_launch_failure_propagates_raw(monkeypatch):
    def failing(k):
        raise KernelLaunchError("spd_inv_logdet kernel launch failed: CUDA error 2 (out of memory)")

    monkeypatch.setattr(spd_linalg, "_forward", failing)
    monkeypatch.setattr(likelihood, "kernel_applies", lambda k: True)
    before = telemetry.snapshot()["counters"].get("fallback.transitions", 0.0)
    x, y = _data()
    with pytest.raises(KernelLaunchError):
        _gp(tgp, device="cpu").fit(x, y)
    assert telemetry.snapshot()["counters"].get("fallback.transitions", 0.0) == before


def _history(degradations):
    return [(d["entry"], d["failure_class"], d["from"], d["to"]) for d in degradations]


def test_rung_history_under_a_host_oom_matches_jax():
    x, y = _data()
    histories = {}
    for label, pkg, ch, fb, kw in (("jax", jgp, j_chaos, j_fallback, {}),
                                   ("port", tgp, chaos, fallback, {"device": "cpu"})):
        with ch.oom_after_calls(0, op="fit.host") as fired, \
                pytest.raises(fb.DegradationExhaustedError) as info:
            _gp(pkg, **kw).fit(x, y)
        assert info.value.failure_class == "oom" and fired[0] == 4
        histories[label] = _history(info.value.degradations)
    assert histories["port"] == histories["jax"] == [
        ("fit", "oom", "native", "iterative"), ("fit", "oom", "iterative", "matfree"),
        ("fit", "oom", "matfree", "host_f64")]


def test_a_fit_under_a_memory_limit_completes_on_iterative():
    x, y = _data()
    limit = 49.5e6
    port_native = memplan.fit_dispatch_bytes(1, 800, 3, 8, "native", family="GaussianProcessRegression")
    port_iter = memplan.fit_dispatch_bytes(1, 800, 3, 8, "iterative",
                                           family="GaussianProcessRegression")
    jax_native = j_memplan.fit_dispatch_bytes(1, 800, 3, 8, "native")
    jax_iter = j_memplan.fit_dispatch_bytes(1, 800, 3, 8, "iterative")
    assert port_iter < limit < port_native and jax_iter < limit < jax_native
    nll = {}
    # the JAX clean fit on its host optimizer (the device one would
    # compile a second program); its L-BFGS walks the same objective
    clean = _gp(jgp, expert=800).fit(x, y)
    j_memplan.set_memory_planning(False)
    try:
        with j_chaos.memory_limit_bytes(limit) as fired:
            limited = _gp(jgp, expert=800, optimizer="device").fit(x, y)
    finally:
        j_memplan.set_memory_planning(None)
    assert fired[0] == 1
    nll["jax"] = (clean.instr.metrics["final_nll"], limited.instr.metrics["final_nll"],
                  _history(limited.degradations))
    clean = _gp(tgp, expert=800, device="cpu").fit(x, y)
    with chaos.memory_limit_bytes(limit) as fired:
        limited = _gp(tgp, expert=800, device="cpu").fit(x, y)
    assert fired[0] == 1 and limited.metrics["solver_lane"] == "iterative"
    assert limited.run_journal["degradations"] == limited.degradations
    nll["port"] = (clean.metrics["final_nll"], limited.metrics["final_nll"],
                   _history(limited.degradations))
    for clean_nll, limited_nll, history in nll.values():
        assert history == [("fit", "oom", "native", "iterative")]
        assert abs(limited_nll - clean_nll) <= 1e-2 * abs(clean_nll)
    assert abs(nll["port"][1] - nll["jax"][1]) <= 1e-2 * abs(nll["jax"][1])


def test_a_device_fit_under_a_memory_limit_walks_to_matfree():
    """A staged budget between the matfree and iterative rungs' byte models
    of a device fit (one expert of 400 rows): the device optimizer takes
    the solver rungs by the JAX package's rule, so the fit walks native ->
    iterative -> matfree and completes there, on the device loop, its
    ``final_nll`` within 1e-2 relative of the clean device fit's."""
    x, y = _data(400)
    family = "GaussianProcessRegression"
    raw = {rung: memplan.fit_dispatch_bytes(1, 400, 3, 8, rung, family=family)
           for rung in ("native", "iterative", "matfree")}
    assert raw["matfree"] < min(raw["iterative"], raw["native"])
    limit = (raw["matfree"] * min(raw["iterative"], raw["native"])) ** 0.5

    def gp():
        return _gp(tgp, expert=400, device="cpu").setOptimizer("device")

    clean = gp().fit(x, y)
    with chaos.memory_limit_bytes(limit) as fired:
        limited = gp().fit(x, y)
    assert fired[0] == 2
    assert _history(limited.degradations) == [("fit", "oom", "native", "iterative"),
                                              ("fit", "oom", "iterative", "matfree")]
    m = limited.metrics
    assert m["solver_lane"] == "matfree" and m["optimizer"] == "device"
    assert m["solver.matfree_engaged"] == 1.0 and m["device_opt.eager_steps"] >= 1
    assert abs(m["final_nll"] - clean.metrics["final_nll"]) <= 1e-2 * abs(
        clean.metrics["final_nll"])


def test_a_rung_outranks_the_callers_lane_scope_on_its_thread_only():
    # the iterative rung scopes its lane to the fit's thread: under the
    # caller's own solver_lane_scope("exact") the re-run still runs (and
    # ends) on iterative, and the process-wide lane is never set
    x, y = _data()
    with it_ops.solver_lane_scope("exact"), chaos.memory_limit_bytes(49.5e6) as fired:
        limited = _gp(tgp, expert=800, device="cpu").fit(x, y)
        assert it_ops.active_solver_lane() == "exact"
    assert fired[0] == 1 and limited.metrics["solver_lane"] == "iterative"
    assert _history(limited.degradations) == [("fit", "oom", "native", "iterative")]
    assert it_ops._LANE_OVERRIDE is None


def test_kill_switch_restores_raw_propagation(monkeypatch):
    monkeypatch.setenv("GP_FALLBACK", "0")
    x, y = _data()
    with chaos.oom_after_calls(0, op="fit.host"), pytest.raises(torch.cuda.OutOfMemoryError):
        _gp(tgp, device="cpu").fit(x, y)


def test_rung_gates():
    est = _gp(tgp, device="cpu")
    x, y = _data(200)
    data64 = group_for_experts(x, y, 50, dtype=torch.float64, device="cpu")
    data32 = group_for_experts(x, y, 50, dtype=torch.float32, device="cpu")
    # numerical exhaustion gains nothing from float64 on a float64 stack
    assert not fallback._fit_rung_applies(est, "host_f64", fallback.NOT_PSD_EXHAUSTED, set(), data64)
    assert fallback._fit_rung_applies(est, "host_f64", fallback.NOT_PSD_EXHAUSTED, set(), data32)
    assert fallback._fit_rung_applies(est, "host_f64", fallback.OOM, set(), data64)
    for rung in ("segmented", "strict_lane"):
        assert not fallback._fit_rung_applies(est, rung, fallback.OOM, set(), data32)
    assert fallback._next_fit_rung(est, fallback.NOT_PSD_EXHAUSTED, {"native"}, data64) is None
    # an ARD kernel cannot stream: no matfree rung
    ard = tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.ARDRBFKernel(3))
    assert not fallback._fit_rung_applies(ard, "matfree", fallback.OOM, set(), data64)
    # the host_f64 rung re-runs in float64 on the stack's own device
    est._fallback_mode = "host_f64"
    d, extra, cache = est._host_f64_operands(data32, (torch.ones(4),), object())
    assert d.x.dtype == torch.float64 and d.x.device == data32.x.device
    assert extra[0].dtype == torch.float64 and cache is None
    assert est._resolved_optimizer() == "host"


def test_predict_ladder_halvings_match_the_clean_predict():
    x, y = _data()
    model = _gp(tgp, device="cpu").fit(x, y)
    xt = np.random.default_rng(1).normal(size=(300, 3))
    clean_mean, clean_var = model.predict_with_var(xt)
    transitions = telemetry.snapshot()["counters"].get("fallback.rung.chunk_37", 0.0)
    with chaos.oom_after_calls(0, op="predict.chunk", rows_above=40) as fired:
        mean, var = model.predict_with_var(xt)
    # 300 -> 150 -> 75 -> 37 rows a chunk: three halvings, no host rung
    assert fired[0] == 3
    assert telemetry.snapshot()["counters"]["fallback.rung.chunk_37"] == transitions + 1
    np.testing.assert_allclose(mean, clean_mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(var, clean_var, rtol=0, atol=1e-12)
    # a compile failure goes to the last rung: row by row in float64 on
    # the request's device
    with chaos.failing_compile(1, op="predict.chunk"):
        np.testing.assert_allclose(model.predict(xt), clean_mean, rtol=0, atol=1e-12)
    # an OOM at every chunk size ends on the last rung
    host = telemetry.snapshot()["counters"].get("fallback.rung.host_solve", 0.0)
    with chaos.oom_after_calls(0, op="predict.chunk") as fired:
        mean = model.raw_predictor.predict_mean(xt).numpy()
    assert fired[0] == 1 + fallback.MAX_PREDICT_HALVINGS
    assert telemetry.snapshot()["counters"]["fallback.rung.host_solve"] == host + 1
    np.testing.assert_allclose(mean, clean_mean, rtol=0, atol=1e-12)


# -- the precision guard's breach -------------------------------------------


@pytest.fixture
def forced_guard_breach(monkeypatch):
    """Both packages at the mixed lane with its guard bar below 0, so any
    guard breaches (the JAX package's tests/test_fallback.py fixture)."""
    from spark_gp_tpu.ops import precision as j_precision
    from spark_gp_tpu_torch.ops import precision

    monkeypatch.setitem(precision.GUARD_BARS, "mixed", -1.0)
    monkeypatch.setitem(j_precision.GUARD_BARS, "mixed", -1.0)
    prev = precision.set_precision_lane("mixed"), j_precision.set_precision_lane("mixed")
    yield
    precision.set_precision_lane(prev[0])
    j_precision.set_precision_lane(prev[1])


def test_guard_breach_degrades_to_the_strict_lane(forced_guard_breach, monkeypatch):
    """``GP_GUARD_ACTION=degrade``: the breaching fit re-runs on the strict
    lane, one ``guard_breach`` transition ``native -> strict_lane`` in each
    package; the port's re-fit is the strict fit (theta bit-equal) and
    records the strict lane and no guard."""
    monkeypatch.setenv("GP_GUARD_ACTION", "degrade")
    x, y = _data(200)
    j_model = _gp(jgp).fit(x, y)
    model = _gp(tgp, device="cpu").fit(x, y)
    assert _history(model.degradations) == _history(j_model.degradations) == [
        ("fit", "guard_breach", "native", "strict_lane")]
    assert model.metrics["precision_lane"] == "strict"
    assert not any(k.startswith("mixed_precision_guard.") for k in model.metrics)
    from spark_gp_tpu_torch.ops.precision import precision_lane_scope

    with precision_lane_scope("strict"):
        strict = _gp(tgp, device="cpu").fit(x, y)
    assert np.array_equal(model.raw_predictor.theta, strict.raw_predictor.theta)


def test_guard_breach_only_warns_by_default(forced_guard_breach, monkeypatch):
    monkeypatch.delenv("GP_GUARD_ACTION", raising=False)
    x, y = _data(200)
    before = telemetry.snapshot()["counters"].get("fallback.transitions", 0.0)
    model = _gp(tgp, device="cpu").fit(x, y)
    assert not model.degradations
    assert telemetry.snapshot()["counters"].get("fallback.transitions", 0.0) == before
    assert model.metrics["mixed_precision_guard.breach"] == 1.0
    assert model.metrics["precision_lane"] == "mixed"
    # the kill switch keeps the breach a warning even under degrade
    monkeypatch.setenv("GP_GUARD_ACTION", "degrade")
    monkeypatch.setenv("GP_FALLBACK", "0")
    assert _gp(tgp, device="cpu").fit(x, y).metrics["mixed_precision_guard.breach"] == 1.0


def test_guard_action_is_validated(monkeypatch):
    from spark_gp_tpu.ops import precision as j_precision
    from spark_gp_tpu_torch.ops import precision

    monkeypatch.delenv("GP_GUARD_ACTION", raising=False)
    assert precision.guard_action() == j_precision.guard_action() == "log"
    monkeypatch.setenv("GP_GUARD_ACTION", " Degrade ")
    assert precision.guard_action() == "degrade"
    monkeypatch.setenv("GP_GUARD_ACTION", "panic")
    for pkg in (precision, j_precision):
        with pytest.raises(ValueError, match=r"GP_GUARD_ACTION='panic' is not supported; "
                                             r"use one of \['degrade', 'log'\]"):
            pkg.guard_action()


def test_strict_lane_rung_gate_and_the_ppa_ladder():
    from spark_gp_tpu_torch.ops.precision import precision_lane_scope

    est = _gp(tgp, device="cpu")
    assert fallback.LADDERS["ppa"] == j_fallback.LADDERS["ppa"] == ("device_solve", "host_solve")
    assert not fallback._fit_rung_applies(est, "strict_lane", fallback.GUARD_BREACH, set())
    with precision_lane_scope("fast"):
        assert fallback._next_fit_rung(est, fallback.GUARD_BREACH, {"native"}) == "strict_lane"
        assert not fallback._fit_rung_applies(est, "strict_lane", fallback.GUARD_BREACH,
                                              {"native", "strict_lane"})
        # the rung pins the strict lane on its thread for the attempt
        with fallback._fit_rung_scope(est, "strict_lane"):
            from spark_gp_tpu_torch.ops.precision import active_lane

            assert active_lane() == "strict"
        assert active_lane() == "fast"
