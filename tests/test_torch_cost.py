"""Cost attribution (ROADMAP.md item 3, rest; the port's ``obs/cost.py``):
the metering gate, the op table of the library counter, the kernels'
work models against the bound formulas PERF.md §6 prints, the signature
cache and its bound, the journal's ``xla_cost`` block against the JAX
package's on the same tiny fit, and that metering changes no result."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.obs import cost as j_cost
from spark_gp_tpu_torch.obs import cost
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.ops import lane_gram, slq_quadrature, spd_linalg
from spark_gp_tpu_torch.ops import streamed_matvec as sm
from spark_gp_tpu_torch.ops.iterative import solver_lane_scope
from spark_gp_tpu_torch.ops.precision import chip_peaks
from spark_gp_tpu_torch.resilience import memplan

P = 3
#: the card PERF.md §6's bounds are stated for
H100 = chip_peaks("NVIDIA H100 80GB HBM3")


@pytest.fixture
def metering():
    cost.set_cost_metering(True)
    try:
        yield
    finally:
        cost.set_cost_metering(None)


def _gp(m, optimizer="host", **kw):
    return (m.GaussianProcessRegression(**kw)
            .setKernel(lambda: 1.0 * m.ARDRBFKernel(P) + m.Const(1.0) * m.EyeKernel())
            .setDatasetSizeForExpert(40).setActiveSetSize(20).setSigma2(1e-3)
            .setMaxIter(5).setSeed(7).setOptimizer(optimizer))


def _data(n=120, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    return x, np.sin(x.sum(1)) + 0.1 * rng.normal(size=n)


def _bound_ms(work, peak=None):
    """PERF.md §6's bound: the larger of the bytes over the memory rate
    and the flops over the peak."""
    flops, nbytes = work
    return max(nbytes / H100.bytes_per_s, flops / (peak or H100.f32)) * 1e3


def test_work_models_give_the_bounds_perf_md_prints():
    # K1 at (14, 97) and the lane gram at (14, 97, 5), both x against x
    assert round(_bound_ms(spd_linalg.work(14, 97)), 6) == 0.000315
    assert round(_bound_ms(lane_gram.work(14, 97, 97, 5, "3xtf32", True), H100.tf32), 7) \
        == 0.0001654
    # K2 and K2-VJP: the formulas chip_smoke.py's bound column used
    e, s, p = 9, 4065, 9
    half, pairs = e * s * (s - 1) // 2, e * s * s
    for n in (1, 8, 9):
        assert sm.work(e, s, p, n) == (half * (2 * p + 3) + pairs * 2 * n, 4 * e * s * (p + 2 * n))
        assert sm.work_vjp(e, s, p, n) == (half * (2 * p + 8 + 4 * n), 4 * e * s * (p + 2 * n))
    assert sm.exps(e, s) == half
    # the quadrature: t^2 QL rotations a matrix, diag/off/result moved once
    assert slq_quadrature.work(72, 64) == (72 * 64 * 64 * 25, (72 * 64 + 72 * 63 + 72) * 4)
    # the operand read once for a self gram, twice otherwise; one TF32 pass
    assert lane_gram.work(2, 10, 12, 4, "tf32") == (2 * 2 * 10 * 12 * 4,
                                                    (2 * 10 * 4 + 2 * 12 * 4 + 2 * 10 * 12) * 4)


def test_chip_peaks_table():
    assert H100.key == "H100" and H100.f32 == 67e12 and H100.tf32 == 495e12
    assert chip_peaks("NVIDIA H100 PCIe").bytes_per_s == 2.0e12
    assert chip_peaks("cpu") is None and chip_peaks(None) is None


@pytest.mark.parametrize("op,expect", [
    (lambda a, b, c: a @ b, 2 * 6 * 5 * 4),
    (lambda a, b, c: torch.linalg.cholesky_ex(c), 7 ** 3 / 3),
    (lambda a, b, c: torch.linalg.solve_triangular(c, c[:, :2], upper=False), 7 * 7 * 2),
    (lambda a, b, c: a + 1.0, 6 * 5),
    (lambda a, b, c: torch.sum(c), 49),
])
def test_library_counter_prices_operations_by_the_table(op, expect):
    a = torch.ones(6, 5, dtype=torch.float64)
    b = torch.ones(5, 4, dtype=torch.float64)
    c = torch.eye(7, dtype=torch.float64) * 2.0
    out, got = cost.measure(op, (a, b, c))
    assert got["flops"] == expect
    assert got["bytes"] > 0 and "peak_bytes" not in got   # no peak on the CPU


def test_a_kernel_plain_branch_reports_the_kernel_work_and_pauses_the_counter():
    k = torch.eye(9, dtype=torch.float64).repeat(3, 1, 1) * 2.0
    with cost._execution() as ex:
        _, got = cost.measure(lambda m: spd_linalg.spd_inv_logdet(m), (k,))
    assert got["flops"] == 0.0 and got["bytes"] == 0.0
    launches, flops, nbytes = ex.kernels["spd_inv_logdet"]
    assert (launches, (flops, nbytes)) == (1.0, spd_linalg.work(3, 9, 8))


def test_metering_off_never_enters_the_counter(monkeypatch):
    def refuse(self):
        raise AssertionError("the counter was entered with metering off")

    monkeypatch.setattr(cost._Measurement, "start", refuse)
    before = dict(telemetry.snapshot()["counters"])
    model = _gp(tgp, device="cpu").fit(*_data())
    assert model.run_journal["xla_cost"] is None
    after = telemetry.snapshot()["counters"]
    assert not any(k.startswith("xla.") and after[k] != before.get(k) for k in after)


@pytest.mark.parametrize("optimizer", ["host", "device"])
def test_a_metered_fit_is_bit_equal_and_counts_its_executions(metering, optimizer):
    x, y = _data()
    cost.set_cost_metering(False)
    plain = _gp(tgp, optimizer, device="cpu").fit(x, y)
    cost.set_cost_metering(True)
    metered = _gp(tgp, optimizer, device="cpu").fit(x, y)
    np.testing.assert_array_equal(metered.raw_predictor.theta, plain.raw_predictor.theta)
    np.testing.assert_array_equal(metered.predict(x[:7]), plain.predict(x[:7]))
    xc = metered.run_journal["xla_cost"]
    (entry,) = xc["entries"]
    row = xc["entries"][entry]
    assert entry == "fit.GaussianProcessRegression"
    m = metered.metrics
    # host: one execution an evaluation; device: one a step (eager here)
    # and one for the initial evaluation, which runs before any step
    want = m["lbfgs_nfev"] if optimizer == "host" else m["device_opt.eager_steps"] + 1
    assert row["executions"] == want > 0
    assert row["flops_total"] == row["flops_per_execution"] * want > 0
    assert xc["measured_mfu_optimize"] is None   # no device figure on the CPU
    assert cost.measured_flops(entry) >= xc["flops_total"]


def test_journal_cost_block_matches_the_jax_package(metering):
    x, y = _data()
    j_cost.set_cost_metering(True)
    try:
        jx = _gp(jgp).fit(x, y).run_journal["xla_cost"]
    finally:
        j_cost.set_cost_metering(None)
    tx = _gp(tgp, device="cpu").fit(x, y).run_journal["xla_cost"]
    assert set(tx) == set(jx)
    assert set(tx["entries"]) == set(jx["entries"])
    for entry, jrow in jx["entries"].items():
        assert set(jrow) - {"peak_bytes_per_execution"} <= set(tx["entries"][entry])
        assert tx["entries"][entry]["executions"] == jrow["executions"]


def test_kernels_metered_work_equals_work_times_launches_on_the_matfree_lane(metering):
    """The plain branches report their kernels' work per call: a metered
    matfree fit's K2, K2-VJP and quadrature rows equal the work model of
    every call the fit made."""
    calls = {"streamed_matvec": [], "streamed_matvec_vjp": [], "slq_quadrature": []}
    real = cost.note_kernel

    def spy(name, work, launches=1.0):
        # the launches inside a metered execution (the evaluations); the
        # post-fit probe runs outside one
        if name in calls and work is not None and getattr(cost._STATE, "execution", None):
            calls[name].append((launches, work))
        return real(name, work, launches)

    x, y = _data(n=160, seed=3)
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
          .setDatasetSizeForExpert(80).setActiveSetSize(20).setMaxIter(2).setSeed(1))
    with pytest.MonkeyPatch.context() as mp, solver_lane_scope("matfree"):
        mp.setattr(cost, "note_kernel", spy)
        model = gp.fit(x, y)
    (row,) = model.run_journal["xla_cost"]["entries"].values()
    for name, seen in calls.items():
        assert seen, name
        k = row["kernels"][name]
        assert k["launches"] == sum(n for n, _ in seen)
        assert k["flops"] == sum(w[0] for _, w in seen)
        assert k["bytes"] == sum(w[1] for _, w in seen)
    # each call's work is the model at the fit's shapes, (E, s, p) = (2, 80, 3)
    models = {sm.work(2, 80, P, n, 8) for n in range(1, 33)}
    assert all(w in models for _, w in calls["streamed_matvec"])


def test_predict_chunks_are_executions(metering):
    x, y = _data()
    model = _gp(tgp, device="cpu").fit(x, y)
    before = telemetry.snapshot()["counters"].get("xla.flops.predict.ppa", 0.0)
    model.raw_predictor._PREDICT_CHUNK_ELEMS = 20 * 25    # 25-row chunks
    model.predict_with_var(x[:60])
    assert telemetry.snapshot()["counters"]["xla.flops.predict.ppa"] > before


def test_signature_cache_is_fifo_bounded_and_dies_with_its_function(monkeypatch):
    monkeypatch.setattr(cost, "_CACHE_MAX", 3)
    cost.clear_cache()

    def f(t):
        return t * 2.0

    for n in range(5):
        cost.measure(f, (torch.ones(n + 1),))
    assert len(cost._CACHE) == 3
    kept = {k[1] for k in cost._CACHE}
    assert (("t", (("a", (1,), "torch.float64"),)) not in kept
            and ("t", (("a", (5,), "torch.float32"),)) in kept)
    del f
    import gc

    gc.collect()
    assert not cost._CACHE


def test_memory_plan_rows_compare_like_for_like_and_calibrate():
    from spark_gp_tpu_torch.obs.runtime import FitCapture, _memory_plan_rows
    from spark_gp_tpu_torch.utils.instrumentation import Instrumentation

    memplan.reset_calibration()
    key = memplan.fit_model_key("GaussianProcessRegression", "native")
    memplan.note_expected_dispatch(key, 100.0)
    memplan.note_compiled_peak("predict.ppa", 500.0)          # another kind: ignored
    assert memplan.calibration_scale(key) == 1.0
    memplan.note_compiled_peak("fit.GaussianProcessRegression", 150.0)
    assert memplan.calibration_scale(key) == 1.5
    assert memplan.compiled_peak("fit.GaussianProcessRegression") == 150.0
    instr = Instrumentation()
    instr.memory_plan = [{"entry": "fit", "predicted_bytes": 120.0, "fits": True}]
    cap = FitCapture("t")
    cap.note_xla_cost("fit.X", {"flops": 1.0, "bytes": 1.0, "peak_bytes": 130.0})
    (row,) = _memory_plan_rows(instr, cap)
    assert row["compiled_peak_bytes"] == 130.0 and row["margin_breach"] is True
    memplan.reset_calibration()
    assert memplan.compiled_peaks() == {}


def test_capture_rows_split_distinct_programs_and_sum_kernels():
    from spark_gp_tpu_torch.obs.runtime import FitCapture

    cap = FitCapture("t")
    cap.note_xla_cost("e", {"flops": 2.0, "bytes": 3.0}, 2.0, {"k": [1.0, 10.0, 20.0]})
    cap.note_xla_cost("e", {"flops": 2.0, "bytes": 3.0}, 1.0, {"k": [2.0, 20.0, 40.0]})
    cap.note_xla_cost("e", {"flops": 5.0, "bytes": 3.0})
    assert set(cap.xla_costs) == {"e", "e#2"}
    assert cap.xla_costs["e"]["executions"] == 3.0
    assert cap.xla_costs["e"]["kernels"]["k"] == {"launches": 3.0, "flops": 30.0, "bytes": 60.0}


def test_cost_counters_render_with_the_entry_label(metering):
    from spark_gp_tpu_torch.obs.expo import render_openmetrics
    from spark_gp_tpu_torch.serve.metrics import ServingMetrics

    _gp(tgp, device="cpu").fit(*_data())
    page = render_openmetrics(ServingMetrics(), telemetry.snapshot())
    assert 'gp_xla_flops_total{entry="fit.GaussianProcessRegression"}' in page
    assert 'gp_xla_bytes_total{entry="fit.GaussianProcessRegression"}' in page


def test_mfu_is_none_without_a_card():
    assert cost.mfu_against_peak(1e12, 1.0) is None
    assert cost.mfu_against_peak(0.0, 1.0) is None


def test_serve_batches_are_executions_of_the_batch_root(metering, tmp_path):
    from spark_gp_tpu_torch.serve import GPServeServer

    x, y = _data()
    model = _gp(tgp, device="cpu").fit(x, y)
    model.save(str(tmp_path / "m.npz"))
    server = GPServeServer(max_batch=16, device="cpu", quality=False)
    server.register("m", str(tmp_path / "m.npz"))
    server.start()
    try:
        before = telemetry.snapshot()["counters"].get("xla.flops.serve.batch", 0.0)
        for i in range(3):
            server.predict("m", x[i:i + 5])
        assert telemetry.snapshot()["counters"]["xla.flops.serve.batch"] > before
    finally:
        server.stop()


def test_a_device_loops_initial_evaluation_is_one_execution_with_its_peak(metering):
    """The device optimizer's initial evaluation runs eagerly before the
    captured step: it is metered as one execution at the step's cost, with
    its own peak as the loop's per-execution peak (a capture can read
    none), and alone, where no step follows, at its own cost.  The memory
    plan then compares that peak, not the whole fit's."""
    from spark_gp_tpu_torch.obs import runtime as obs_runtime
    from spark_gp_tpu_torch.obs.runtime import FitCapture, _memory_plan_rows
    from spark_gp_tpu_torch.utils.instrumentation import Instrumentation

    x = torch.ones(64, dtype=torch.float64)
    with obs_runtime.fit_capture("t") as cap:
        meter = cost.ReplayMeter("fit.device")
        with meter.initial():
            (x * 2.0).sum()
            cost.note_kernel("spd_inv_logdet", (10.0, 20.0))
        # the step, measured at its first eager run, then replayed twice
        with meter.eager_step():
            (x * 3.0 + 1.0).sum()
            cost.note_kernel("spd_inv_logdet", (10.0, 20.0))
        with meter.replays(2.0):
            cost.note_kernel("spd_inv_logdet", (20.0, 40.0), launches=2.0)
        meter.finish()
    (row,) = cap.xla_costs.values()
    assert row["executions"] == 4.0
    assert row["kernels"]["spd_inv_logdet"] == {"launches": 4.0, "flops": 40.0, "bytes": 80.0}
    with obs_runtime.fit_capture("t") as alone:
        meter = cost.ReplayMeter("fit.device")
        with meter.initial():
            (x * 2.0).sum()
        meter.finish()
    (row,) = alone.xla_costs.values()
    assert row["executions"] == 1.0 and row["flops_per_execution"] > 0
    # a captured step has no peak of its own: the row keeps the initial one
    cap2 = FitCapture("t")
    token = obs_runtime._active_capture.set(cap2)
    try:
        meter = cost.ReplayMeter("fit.device")
        meter._initial = ({"flops": 1.0, "bytes": 2.0, "peak_bytes": 100.0}, {})
        meter.cost = {"flops": 5.0, "bytes": 6.0}
        with meter.replays(3.0):
            pass
    finally:
        obs_runtime._active_capture.reset(token)
    (row,) = cap2.xla_costs.values()
    assert row["executions"] == 4.0 and row["peak_bytes_per_execution"] == 100.0
    # the plan compares the per-execution peak, not the fit's 500
    cap2.memory_samples.append({"phase": "optimize_hypers", "memory.peak_bytes_in_use": 500.0})
    instr = Instrumentation()
    instr.memory_plan = [{"entry": "fit", "predicted_bytes": 120.0, "fits": True}]
    (plan_row,) = _memory_plan_rows(instr, cap2)
    assert plan_row["compiled_peak_bytes"] == 100.0 and plan_row["actual_peak_bytes"] == 500.0
    assert plan_row["margin_breach"] is False
