"""The matrix-free lane of GP regression end to end, port against the JAX
package (float64, CPU, the JAX probes injected, preconditioner rank 16 < s
and CG run to convergence; see ``_torch_solver_helpers``).

* ``masked_matfree_operator`` (jitter None and 1e-3) within 1e-12;
* ``batched_nll`` value and gradient on the matfree and iterative lanes,
  with a ragged masked expert, within 1e-8;
* a small GPR fit on ``setSolverLane("matfree")``: fitted theta and
  predictions within 1e-6 relative, and the ``solver.*`` metrics;
* a spy kernel whose ``gram`` raises runs the matfree lane untouched.
"""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models.likelihood import make_value_and_grad as j_vag
from spark_gp_tpu.models.likelihood import masked_matfree_operator as j_operator
from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.convert import FIELDS, predictor_from_fields
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad as t_vag
from spark_gp_tpu_torch.models.likelihood import masked_matfree_operator as t_operator
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

P = 3

KERNELS = {
    # the protein-matfree configuration's kernel, at a small size
    "rbf": lambda m: 1.0 * m.RBFKernel(1.0, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0, 1)
    + m.Const(1e-3) * m.EyeKernel(),
    "matern32": lambda m: 1.5 * m.Matern32Kernel(0.8) + m.Const(1e-2) * m.EyeKernel(),
    "dot": lambda m: 0.5 * m.DotProductKernel(0.5) + m.Const(0.1) * m.EyeKernel(),
}


def _data(n=157, seed=0):
    """157 rows at expert size 30: E = 5 experts of s = 32, two of them
    padded (a ragged masked expert)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    y = np.sin(x @ np.array([1.0, 0.5, -0.7])) + 0.1 * rng.normal(size=n)
    return x, y


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("jitter", [None, 1e-3])
def test_masked_operator_matches_jax(solver_env, jitter):
    x, y = _data()
    jk, tk = KERNELS["rbf"](jgp), KERNELS["rbf"](tgp)
    jd, td = j_group(x, y, 30), t_group(x, y, 30)
    assert float(td.mask.min()) == 0.0
    theta = jk.init_theta() * 0.9
    j_ops = j_operator(jk, jnp.asarray(theta), jd.x, jd.mask, jitter)
    t_ops = t_operator(tk, torch.as_tensor(theta), td.x, td.mask, jitter)
    v = np.random.default_rng(1).normal(size=tuple(td.x.shape[:2]) + (3,))
    for j_mv, t_mv in zip(j_ops[:2], t_ops[:2]):
        assert _rel(t_mv(torch.as_tensor(v)).detach().numpy(), j_mv(jnp.asarray(v))) <= 1e-12
    assert _rel(t_ops[2].numpy(), j_ops[2]) <= 1e-12
    piv = np.array([0, 5, 31, 17, 2])
    assert _rel(t_ops[3](torch.as_tensor(piv)).numpy(), j_ops[3](jnp.asarray(piv))) <= 1e-12


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("lane", ["matfree", "iterative"])
def test_batched_nll_matches_jax(solver_env, name, lane):
    x, y = _data()
    jk, tk = KERNELS[name](jgp), KERNELS[name](tgp)
    theta = jk.init_theta() * 0.8
    j_it.set_solver_lane(lane)
    t_it.set_solver_lane(lane)
    j_v, j_g = j_vag(jk, j_group(x, y, 30))(theta)
    t_v, t_g = t_vag(tk, t_group(x, y, 30))(theta)
    assert abs(t_v - float(j_v)) <= 1e-8 * abs(float(j_v))
    assert _rel(t_g, j_g) <= 1e-8


def _estimator(m, **kw):
    return (
        m.GaussianProcessRegression(**kw)
        .setKernel(lambda: 1.0 * m.RBFKernel(1.0, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0, 1))
        .setDatasetSizeForExpert(60)
        .setActiveSetSize(40)
        .setSigma2(1e-3)
        .setMaxIter(15)
        .setSeed(7)
        .setSolverLane("matfree")
    )


def test_matfree_fit_matches_jax_and_round_trips(solver_env):
    x, y = _data(n=238)
    xt = np.random.default_rng(2).normal(size=(30, P))
    j_model = _estimator(jgp).setOptimizer("host").fit(x, y)
    t_model = _estimator(tgp, device="cpu").fit(x, y)
    assert t_it.active_solver_lane() == "matfree"
    np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta, rtol=1e-6)
    np.testing.assert_array_equal(t_model.raw_predictor.active, j_model.raw_predictor.active)
    j_mean, j_var = j_model.predict_with_var(xt)
    t_mean, t_var = t_model.predict_with_var(xt)
    np.testing.assert_allclose(t_mean, j_mean, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_mean)))
    np.testing.assert_allclose(t_var, j_var, rtol=1e-6)
    metrics, j_metrics = t_model.metrics, j_model.instr.metrics
    assert metrics["solver_lane"] == "matfree" and metrics["solver.matfree_engaged"] == 1.0
    for key in ("solver.cg_iters", "solver.precond_rank", "solver.probes",
                "solver.matvec_tiles", "solver.residual"):
        assert key in metrics, key
    assert metrics["solver.precond_rank"] == j_metrics["solver.precond_rank"] == 16.0
    assert metrics["solver.probes"] == j_metrics["solver.probes"]
    assert metrics["solver.residual"] < 1e-10
    # a model fitted on the matfree lane carries across like any other
    fields = {name: getattr(t_model.raw_predictor, name) for name in FIELDS}
    copy = predictor_from_fields(fields, t_model.raw_predictor.kernel, device="cpu")
    np.testing.assert_array_equal(copy.predict_mean(xt).numpy(), t_mean)


class _SpyRBF(tgp.RBFKernel):
    """An RBF whose materialized gram must never be built."""

    def gram(self, theta, x):
        raise AssertionError("the matfree lane built the gram")


def test_matfree_lane_never_builds_the_gram(solver_env):
    x, y = _data()
    kernel = 1.0 * _SpyRBF(1.0) + tgp.Const(1e-2) * tgp.EyeKernel()
    data = t_group(x, y, 30)
    t_it.set_solver_lane("matfree")
    value, grad = t_vag(kernel, data)(kernel.init_theta())
    assert np.isfinite(value) and np.all(np.isfinite(grad))
    metrics = {}
    tgp.GaussianProcessRegression()._emit_solver_stats(metrics, kernel, kernel.init_theta(), data)
    assert metrics["solver.matfree_engaged"] == 1.0
    t_it.set_solver_lane("iterative")
    with pytest.raises(AssertionError, match="built the gram"):
        t_vag(kernel, data)(kernel.init_theta())


def test_kernel_that_cannot_stream_runs_materialized(solver_env):
    """matfree asked, ARD kernel: the materialized iterative lane, stamped
    ``solver.matfree_engaged = 0``; the exact lane stamps only its name."""
    x, y = _data()
    kernel = 1.0 * tgp.ARDRBFKernel(P) + tgp.Const(1e-2) * tgp.EyeKernel()
    data = t_group(x, y, 30)
    gp = tgp.GaussianProcessRegression(device="cpu")
    metrics = {}
    gp._emit_solver_stats(metrics, kernel, kernel.init_theta(), data)
    assert metrics == {"solver_lane": "exact"}
    gp.setSolverLane("matfree")
    gp._emit_solver_stats(metrics, kernel, kernel.init_theta(), data)
    assert metrics["solver_lane"] == "matfree" and metrics["solver.matfree_engaged"] == 0.0
    assert "solver.matvec_tiles" not in metrics and metrics["solver.cg_iters"] > 0
