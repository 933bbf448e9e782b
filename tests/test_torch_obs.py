"""The port's observability shell (``obs/``, ``utils/instrumentation.py``,
``models/common._observed_fit``) against the JAX package's, float64 on
the CPU, on the same seeded regression fit (800 rows, expert 50, maxiter
3, the JAX side on its host optimizer).  Held exactly: the span tree's
names and nesting, the run journal's keys and the incident bundle's
top-level keys (with ``kernels`` in place of the JAX package's compile
counts), and the OpenMetrics page of one metrics dict (the ``gp_build``
identity family aside: it names each package's own framework).  The
metric-name lint passes on the port and fails on planted bad keys."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import json
import os

import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.obs import expo as j_expo
from spark_gp_tpu.obs import recorder as j_recorder
from spark_gp_tpu.obs import runtime as j_runtime
from spark_gp_tpu.resilience import chaos as j_chaos
from spark_gp_tpu.resilience import fallback as j_fallback
from spark_gp_tpu.utils.instrumentation import Instrumentation as JInstrumentation
from spark_gp_tpu_torch.obs import expo, names, recorder, runtime, trace
from spark_gp_tpu_torch.ops import cuda_lib, spd_linalg
from spark_gp_tpu_torch.models import likelihood
from spark_gp_tpu_torch.resilience import chaos, fallback
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation

PHASES = ["group_experts", "optimize_hypers", "active_set", "kmn_stats", "magic_solve"]


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(800, 3))
    return x, np.sin(x.sum(1))


def _gp(pkg, **kw):
    gp = (pkg.GaussianProcessRegression(**kw).setKernel(lambda: pkg.RBFKernel(1.0))
          .setDatasetSizeForExpert(50).setActiveSetSize(50).setMaxIter(3))
    return gp.setOptimizer("host") if pkg is jgp else gp


def _shape(node):
    """(name, [children's shapes]) of a span tree node."""
    return node["name"], [_shape(c) for c in node["children"]]


def test_span_tree_and_journal_keys_match_jax():
    x, y = _data()
    j_model = _gp(jgp).fit(x, y)
    t_model = _gp(tgp, device="cpu").fit(x, y)
    j_tree = [_shape(n) for n in j_model.run_journal["spans"]]
    t_tree = [_shape(n) for n in t_model.run_journal["spans"]]
    assert t_tree == j_tree == [("fit.GaussianProcessRegression", [(p, []) for p in PHASES])]
    expected = (set(j_model.run_journal) - {"compiles", "compiles_by_entry"}) | {"kernels"}
    assert set(t_model.run_journal) == expected
    assert runtime.validate_journal(t_model.run_journal) == []
    # memory sampled at the start, at each phase boundary and at the end
    samples = t_model.run_journal["memory"]["samples"]
    assert [s["phase"] for s in samples] == ["start"] + PHASES + ["end"]
    assert all("memory.host_peak_rss_bytes" in s for s in samples)
    assert set(t_model.instr.timings) == set(PHASES)
    m = t_model.metrics
    assert m["ppa_seconds"] == pytest.approx(sum(t_model.instr.timings[p] for p in PHASES[2:]),
                                             rel=1e-12)
    assert m["group_seconds"] == t_model.instr.timings["group_experts"]


def test_incident_bundle_keys_match_jax(tmp_path, monkeypatch):
    x, y = _data()
    bundles = {}
    for label, pkg, ch, fb in (("jax", jgp, j_chaos, j_fallback), ("port", tgp, chaos, fallback)):
        directory = tmp_path / label
        monkeypatch.setenv("GP_INCIDENT_DIR", str(directory))
        kw = {} if pkg is jgp else {"device": "cpu"}
        with ch.oom_after_calls(0, op="fit.host"), pytest.raises(fb.DegradationExhaustedError):
            _gp(pkg, **kw).fit(x, y)
        files = sorted(os.listdir(directory))
        assert len(files) == 1, files
        bundles[label] = json.loads((directory / files[0]).read_text())
    j_keys = set(bundles["jax"])
    assert set(bundles["port"]) == (j_keys - {"compiles"}) | {"kernels"}
    assert recorder.validate_bundle(bundles["port"]) == []
    assert j_recorder.validate_bundle(bundles["jax"]) == []
    # the failing span tree: the errored root with its ladder events
    root = bundles["port"]["spans"][0]
    assert root["name"] == "fit.GaussianProcessRegression" and root["status"] == "error"
    events = [e["name"] for e in root["events"]]
    assert events.count("fallback.engaged") == 3 and events[-1] == "error"
    assert bundles["port"]["failure_class"] == bundles["jax"]["failure_class"] == "oom"


def _filled(instr):
    instr.timings.update({"group_experts": 0.25, "optimize_hypers": 1.5, "magic_solve": 0.125})
    instr.metrics.update({"num_experts": 16, "final_nll": -920.8081323, "solver_lane": "exact",
                          "fallback.engaged": 1.0, "optimize_hypers.failed": 1.0,
                          "agg.policy": "poe", "restart_2_nll": 3.5})
    return instr


def test_openmetrics_page_matches_jax():
    snapshot = {
        "counters": {"fallback.transitions": 3.0, "fallback.failures.oom": 4.0,
                     "fallback.rung.host_f64": 1.0, "plan.hit": 2.0, "incident.bundles": 1.0},
        "per_entry": {"fallback.transitions": {"fit": 3.0}, "plan.hit": {"predict": 2.0}},
        "gauges": {"memory.bytes_in_use": 1024.0, "memory.peak_bytes_in_use": 4096.5},
    }
    j_page = j_expo.render_openmetrics(_filled(JInstrumentation(name="g")), snapshot)
    t_page = expo.render_openmetrics(_filled(Instrumentation(name="g")), snapshot)

    def without_build(page):
        return [ln for ln in page.splitlines() if "gp_build" not in ln]

    assert without_build(t_page) == without_build(j_page)
    assert t_page.endswith("# EOF\n") and "gp_build_info{" in t_page
    # a kernel's launches by entry keep the kernel label beside the entry
    page = expo.render_openmetrics(Instrumentation(), {
        "counters": {}, "gauges": {},
        "per_entry": {"kernel.launches.spd_inv_logdet": {"fit.G": 5.0},
                      "kernel.launches.streamed_matvec": {"fit.G": 7.0}}})
    assert 'gp_kernel_launches_by_entry_total{entry="fit.G",kernel="spd_inv_logdet"} 5' in page


def test_metric_name_lint_passes_on_the_port_and_fails_on_planted_keys(tmp_path):
    assert names.check_package() == []
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "def f(instr, telemetry, span, k):\n"
        "    instr.log_metric('Bad.Key', 1)\n"
        "    telemetry.inc('kernel.compiles.x')\n"
        "    span.add_event(f'fallback.rungs.{k}')\n"
        "    instr.metrics['num_experts'] = 1\n"
        "    telemetry.inc('not.registered')  # metric-name-ok\n"
    )
    found = names.check_package(str(pkg))
    assert [(v[1], v[2]) for v in found] == [
        (2, "Bad.Key"), (3, "kernel.compiles.x"), (4, "fallback.rungs.*")]


def test_tracing_off_keeps_the_fit_and_drops_the_journal():
    x, y = _data()
    trace.set_tracing(False)
    try:
        model = _gp(tgp, device="cpu").fit(x, y)
    finally:
        trace.set_tracing(None)
    assert model.run_journal is None and np.isfinite(model.metrics["final_nll"])


def test_journal_persists_and_the_ring_exports(tmp_path, monkeypatch):
    monkeypatch.setenv("GP_RUN_JOURNAL_DIR", str(tmp_path))
    x, y = _data()
    model = _gp(tgp, device="cpu").fit(x, y)
    path = model.run_journal["path"]
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    assert runtime.validate_journal(json.loads(open(path).read())) == []
    spans = trace.spans_for_trace(trace.RING.snapshot()[-1].trace_id)
    doc = trace.chrome_trace(spans)
    complete = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert complete == ["fit.GaussianProcessRegression"] + PHASES
    assert trace.export_jsonl(str(tmp_path / "spans.jsonl"), spans) == len(PHASES) + 1


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    x, y = _data()
    model = _gp(tgp, device="cpu").setProfileDir(str(tmp_path)).fit(x, y)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("trace_GaussianProcessRegression")
    doc = json.loads((tmp_path / files[0]).read_text())
    assert doc["traceEvents"] and np.isfinite(model.metrics["final_nll"])


def test_kernel_launches_attribute_to_the_fit_root(monkeypatch):
    """K1's wrapper counts ``kernel.launches.spd_inv_logdet`` under the
    fit's root span; here its CPU stand-in counts the way the wrapper does
    on the card (the plain version, then ``cuda_lib.count_launch``)."""
    def counted(k):
        out = spd_linalg.spd_inv_logdet_plain(k)
        cuda_lib.count_launch("spd_inv_logdet")
        return out

    monkeypatch.setattr(spd_linalg, "_forward", counted)
    monkeypatch.setattr(likelihood, "kernel_applies", lambda k: True)
    x, y = _data()
    model = _gp(tgp, device="cpu").fit(x, y)
    kernels = model.run_journal["kernels"]
    # one a evaluation, and one for the fit-time expert-quality probe's
    # single batched pass over the stack
    launches = model.metrics["lbfgs_nfev"] + 1
    assert kernels["launches"] == {"spd_inv_logdet": launches}
    assert kernels["by_entry"]["kernel.launches.spd_inv_logdet"] == {
        "fit.GaussianProcessRegression": launches}


def test_phase_marks_failure_and_samples_memory():
    instr = Instrumentation(name="t")
    with pytest.raises(ValueError), instr.phase("kmn_stats"):
        raise ValueError("boom")
    assert instr.metrics["kmn_stats.failed"] == 1.0 and "kmn_stats" in instr.timings
    sample = runtime.telemetry.sample_memory()
    assert sample["memory.host_peak_rss_bytes"] > 0
    assert runtime.build_info()["package"] == "spark_gp_tpu_torch"
    assert torch.cuda.is_available() or runtime.build_info()["backend"] == "cpu"
