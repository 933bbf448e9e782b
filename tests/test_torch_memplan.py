"""The port's memory planner (``resilience/memplan.py``) and budget-aware
``auto`` lane (``ops/iterative.resolve_solver``) against the JAX
package's, on the CPU.  Held exactly: the decisions of ``plan_dispatch``
and ``plan_predict_chunk`` on the same candidates and budget (the two
packages share the predict byte model), and the lane ``resolve_solver``
picks when both price the iterative program at the same bytes against
the same budget.  The calibration only ratchets upward; the budget
resolves staged limit > ``GP_MEMPLAN_LIMIT_BYTES`` > the card (None
here, where no CUDA context exists)."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import numpy as np
import pytest
import torch

import spark_gp_tpu_torch as tgp
from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu.resilience import chaos as j_chaos
from spark_gp_tpu.resilience import memplan as j_memplan
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.parallel.experts import group_for_experts
from spark_gp_tpu_torch.resilience import chaos, memplan

CANDIDATES = [
    [("native", 9.0e8), ("iterative", 4.0e8), ("matfree", 3.0e7)],
    [("native", 1.0e6), ("iterative", 4.0e8)],
    [("a", 5.0e8), ("b", 7.0e8), ("c", 6.0e8)],
    [("only", 2.0e9)],
]
BUDGETS = [1.0e6, 4.0e7, 5.0e8, 6.0e8, 1.2e9, 3.0e9]


def _row(d):
    return None if d is None else (d.chosen, d.fits, d.raw_bytes, d.predicted_bytes,
                                   d.budget_bytes, [c["name"] for c in d.candidates if c["fits"]])


@pytest.mark.parametrize("case", range(len(CANDIDATES)))
def test_plan_dispatch_decides_as_jax(case):
    for budget in BUDGETS:
        assert _row(memplan.plan_dispatch("fit", CANDIDATES[case], budget)) == _row(
            j_memplan.plan_dispatch("fit", CANDIDATES[case], budget))


@pytest.mark.parametrize("mean_only", [False, True])
def test_plan_predict_chunk_decides_as_jax(mean_only):
    for chunk, m, p, itemsize, budget in [(4096, 1000, 5, 4, 2e7), (1503, 1000, 5, 4, 5e6),
                                          (300, 50, 3, 8, 1e9), (300, 50, 3, 8, 1e3),
                                          (32768, 1000, 9, 4, 1.5e8), (1, 10, 2, 4, 1e6)]:
        assert memplan.predict_dispatch_bytes(chunk, m, p, itemsize, mean_only) == \
            j_memplan.predict_dispatch_bytes(chunk, m, p, itemsize, mean_only)
        with chaos.memory_limit_bytes(budget), j_chaos.memory_limit_bytes(budget):
            assert memplan.plan_predict_chunk(chunk, m, p, itemsize, mean_only) == \
                j_memplan.plan_predict_chunk(chunk, m, p, itemsize, mean_only)
    assert memplan.plan_predict_chunk(4096, 1000, 5, 4, False) is None  # no budget here


def test_calibration_ratchets_upward_only():
    key = memplan.fit_model_key("TestFamily", "native")
    try:
        raw = memplan.fit_dispatch_bytes(4, 100, 3, 4, "native", family="TestFamily")
        memplan.observe_measured(key, raw, 0.5 * raw)
        assert memplan.calibration_scale(key) == 1.0
        memplan.observe_measured(key, raw, 3.0 * raw)
        assert memplan.calibration_scale(key) == pytest.approx(3.0, rel=1e-12)
        memplan.observe_measured(key, raw, 2.0 * raw)
        assert memplan.calibration_scale(key) == pytest.approx(3.0, rel=1e-12)
        assert memplan.fit_dispatch_bytes(4, 100, 3, 4, "native", family="TestFamily") == \
            pytest.approx(3.0 * raw, rel=1e-12)
        # other families and rungs keep their own models
        assert memplan.fit_dispatch_bytes(4, 100, 3, 4, "native", family="Other") == \
            pytest.approx(raw, rel=1e-12)
    finally:
        memplan.reset_calibration()


@pytest.mark.parametrize("priced,budget,s", [
    (1.0e9, 2.0e9, 2048), (1.0e9, 1.1e9, 2048), (1.0e9, 1.3e9, 2048),
    (5.0e8, 1.0e8, 4065), (5.0e8, 1.0e8, 512), (5.0e8, None, 4065),
])
def test_budget_aware_auto_lane_resolves_as_jax(monkeypatch, priced, budget, s):
    monkeypatch.setattr(memplan, "fit_dispatch_bytes", lambda *a, **k: priced)
    monkeypatch.setattr(j_memplan, "fit_dispatch_bytes", lambda *a, **k: priced)
    if budget is None:
        monkeypatch.setattr(j_memplan, "memory_budget_bytes", lambda: None)
        assert it_ops.resolve_solver(s, "auto") == j_it.resolve_solver(s, "auto") == "iterative"
        return
    with chaos.memory_limit_bytes(budget), j_chaos.memory_limit_bytes(budget):
        got = it_ops.resolve_solver(s, "auto", num_experts=9, n_features=9, itemsize=4)
        assert got == j_it.resolve_solver(s, "auto", num_experts=9, n_features=9, itemsize=4)
    expected = "exact" if s < 1024 else ("matfree" if 1.25 * priced > budget else "iterative")
    assert got == expected


def test_budget_resolution_order(monkeypatch):
    assert memplan.memory_budget_bytes() is None  # no CUDA context: no budget
    monkeypatch.setenv("GP_MEMPLAN_LIMIT_BYTES", "123456789")
    assert memplan.memory_budget_bytes() == 123456789.0
    with chaos.memory_limit_bytes(1000):
        assert memplan.memory_budget_bytes() == 1000.0
    monkeypatch.setenv("GP_MEMPLAN", "0")
    assert memplan.plan_dispatch("fit", CANDIDATES[0]) is None
    assert it_ops.resolve_solver(4096, "auto") == "iterative"


def test_byte_models_order_the_lanes_at_the_protein_matfree_shape():
    e, s, p = 9, 4065, 9
    native = memplan.fit_dispatch_bytes(e, s, p, 4, "native")
    iterative = memplan.fit_dispatch_bytes(e, s, p, 4, "iterative")
    matfree = memplan.fit_dispatch_bytes(e, s, p, 4, "matfree")
    gram = e * s * s * 4
    assert matfree < gram / 4 < gram < iterative < native
    assert memplan.fit_rung_of_lane("matfree", streams=False) == "iterative"
    assert memplan.fit_rung_of_lane("exact", streams=True) == "native"


def test_fit_plan_is_none_on_the_host_optimizer():
    # the host optimizer: the fit starts at native whatever the budget
    x = np.random.default_rng(0).normal(size=(400, 3))
    est = tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
    data = group_for_experts(x, x.sum(1), 200, dtype=torch.float32, device="cpu")
    with chaos.memory_limit_bytes(2.0e6):
        assert memplan.plan_fit_dispatch(est, None, data) is None
    assert est._resolved_optimizer() == "host"
