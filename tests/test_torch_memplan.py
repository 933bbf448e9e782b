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


class _LiveBytes:
    """Live bytes of the storages the ops inside the block allocate, and
    their peak (a ``TorchDispatchMode``; a storage counts until it is
    freed): the CPU's view of what the caching allocator measures on the
    card above what was allocated before.  ``untracked(fn)`` runs ``fn``
    counting only its outputs, the stand-in for the streamed product's
    kernel, whose tiles never reach device memory (the CPU's plain version
    materializes them), and for the SLQ quadrature's kernel, which reads
    the tridiagonals where the plain version builds them dense."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not outer.paused:
                    outer.track(out)
                return out

        self.mode, self.paused, self.live, self.peak, self._seen = Mode(), 0, 0, 0, {}

    def track(self, out):
        import weakref

        from torch.utils._pytree import tree_flatten

        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st.data_ptr()
                if key in self._seen or not st.nbytes():
                    continue
                self._seen[key] = st.nbytes()
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def untracked(self, fn):
        def run(*args, **kw):
            self.paused += 1
            try:
                out = fn(*args, **kw)
            finally:
                self.paused -= 1
            self.track(out)
            return out

        return run


def _device_step_peak(vag, theta0, bounds, aux0=None, meter=None):
    """The peak bytes of one device-optimizer step (``lbfgs_step``, the
    step the card captures) above the state it starts from."""
    from spark_gp_tpu_torch.optimize import lbfgs_device as ld

    cfg = ld.LbfgsConfig(lower=bounds[0], upper=bounds[1], tol=1e-6)
    state = ld.lbfgs_init_state(vag, theta0[None], cfg, aux0)
    meter = meter or _LiveBytes()
    with meter.mode:
        ld.lbfgs_step(vag, state, cfg, torch.tensor(100, dtype=torch.int32))
    return meter.peak


@pytest.mark.parametrize("family", ["GaussianProcessRegression", "GaussianProcessClassifier",
                                    "GaussianProcessMulticlassClassifier",
                                    "GaussianProcessPoissonRegression"])
@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_device_step_peaks_on_the_cg_lanes_lie_in_the_bracket(monkeypatch, family, lane):
    """The byte model of a device step on each CG lane (``fit_dispatch_bytes``
    at the lane's rung with the family's latent heads) against one step's
    measured peak plus the stack, float32 at (4, 100, 3): predicted over
    measured in [1, 4], the bracket chip_smoke.py's memplan phases hold on
    the card."""
    from spark_gp_tpu_torch.kernels.base import supports_matfree
    from spark_gp_tpu_torch.models import laplace as lap
    from spark_gp_tpu_torch.models import laplace_generic as gen
    from spark_gp_tpu_torch.models import laplace_mc as mc
    from spark_gp_tpu_torch.models import likelihood as lk
    from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.ops import streamed_matvec as sm

    for var in [v for v in __import__("os").environ if v.startswith("GP_SOLVER_")]:
        monkeypatch.delenv(var)
    meter = _LiveBytes()
    monkeypatch.setattr(sm, "streamed_matvec_plain", meter.untracked(sm.streamed_matvec_plain))
    monkeypatch.setattr(sm, "streamed_matvec_vjp_plain",
                        meter.untracked(sm.streamed_matvec_vjp_plain))
    monkeypatch.setattr(sq, "slq_quadrature_plain", meter.untracked(sq.slq_quadrature_plain))
    rng = np.random.default_rng(0)
    e, s, p = 4, 100, 3
    x = rng.normal(size=(e * s, p))
    f32 = dict(dtype=torch.float32, device="cpu")
    kernel = 1.0 * tgp.RBFKernel(1.0) + tgp.Const(1e-3) * tgp.EyeKernel()
    heads, aux0 = 0, None
    with it_ops.solver_lane_scope(lane):
        if family == "GaussianProcessRegression":
            data = group_for_experts(x, np.sin(x.sum(1)), s, **f32)
            vag = lk.make_device_value_and_grad(kernel, data)
        elif family == "GaussianProcessClassifier":
            data = group_for_experts(x, (x[:, 0] > 0).astype(float), s, **f32)
            vag, heads = lap.BinaryLaplaceLanes(kernel, data, 1e-6), 1
        elif family == "GaussianProcessMulticlassClassifier":
            data = group_for_experts(x, np.clip(np.round(x[:, 0] + 1), 0, 2), s, **f32)
            vag, heads = mc.MulticlassLaplaceLanes(
                kernel, data.x, _one_hot_masked(data.y, data.mask, 3), data.mask, 1e-6), 3
        else:
            data = group_for_experts(x, rng.poisson(np.exp(np.sin(x.sum(1)))).astype(float), s,
                                     **f32)
            vag, heads = gen.GenericLaplaceLanes(gen.PoissonLikelihood(), kernel, data.x, data.y,
                                                 data.mask, 1e-6), 1
        if heads:
            aux0 = vag.aux0(1)
        bounds = tuple(torch.as_tensor(b, **f32) for b in kernel.bounds())
        step = _device_step_peak(vag, torch.as_tensor(kernel.init_theta(), **f32), bounds, aux0,
                                 meter)
    stack = sum(t.numel() * t.element_size() for t in (data.x, data.y, data.mask))
    rung = memplan.fit_rung_of_lane(lane, supports_matfree(kernel))
    predicted = memplan.predicted_bytes(memplan.fit_dispatch_bytes(e, s, p, 4, rung, 1, family,
                                                                   heads))
    assert 1.0 <= predicted / (step + stack) <= 4.0, (predicted, step + stack)
