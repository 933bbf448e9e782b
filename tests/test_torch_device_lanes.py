"""The device optimizer's fits on the CG lanes (``setOptimizer("device")``
on the iterative and matfree lanes), float64 on the CPU, where the loop's
step runs eagerly (the code the card captures), against the JAX
package's device fits under its solver lane, the JAX probe draws
injected (``_torch_solver_helpers``: preconditioner rank 16 < s, CG
tolerance 1e-12).

* The regression fit (``likelihood.fit_gpr_device``) on the iterative and
  matfree lanes against the JAX ``fit_gpr_device``: theta within 1e-6
  relative, the final NLL within 1e-9 relative, ``n_iter`` and ``n_fev``
  equal.
* The binary, multiclass and Poisson device fits on the iterative lane
  against the JAX ``fit_gpc_device`` / ``fit_gpc_mc_device`` /
  ``fit_generic_device`` at ``solver="iterative"``: the same bars, the
  latent modes within 1e-6.
* The fit's probes (``ops.iterative.ProbeSet``) are the per-call draws,
  one ``[E]`` draw shared by R restart lanes; one Newton iteration a step
  gives the CG lanes' default step's fit bit for bit.
* The estimators stamp the lane and the ``solver.*`` report of a device
  fit."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import laplace as j_lap
from spark_gp_tpu.models import laplace_generic as j_gen
from spark_gp_tpu.models import laplace_mc as j_mc
from spark_gp_tpu.models import likelihood as j_lik
from spark_gp_tpu.models.gpc_mc import _one_hot_masked as j_one_hot
from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import laplace as t_lap
from spark_gp_tpu_torch.models import laplace_device
from spark_gp_tpu_torch.models import laplace_generic as t_gen
from spark_gp_tpu_torch.models import laplace_mc as t_mc
from spark_gp_tpu_torch.models import likelihood as t_lik
from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked as t_one_hot
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _regression():
    """100 rows at expert size 25: E = 4 experts of s = 25."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(100, 3))
    return x, np.sin(x @ np.array([1.0, 0.5, -0.7])) + 0.1 * rng.normal(size=100)


def _reg_kernel(m):
    # the protein-matfree configuration's kernel, at a small size
    return 1.0 * m.RBFKernel(1.0, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0, 1) \
        + m.Const(1e-3) * m.EyeKernel()


@pytest.fixture(scope="module")
def jax_regression():
    """The JAX package's regression device fit on each CG lane (its own
    probes: the port's tests inject the same draws)."""
    x, y = _regression()
    data = j_group(x, y, 25)
    kernel = _reg_kernel(jgp)
    lo, hi = (jnp.asarray(b) for b in kernel.bounds())
    out = {}
    for lane in ("iterative", "matfree"):
        env = {"GP_SOLVER_PRECOND_RANK": "16", "GP_SOLVER_CG_TOL": "1e-12"}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with j_it.solver_lane_scope(lane):
                res = j_lik.fit_gpr_device(kernel, True, jnp.asarray(kernel.init_theta()), lo, hi,
                                           data.x, data.y, data.mask, 20, TOL)
        finally:
            for k, v in old.items():
                os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
        out[lane] = [np.asarray(r) for r in res]
    return out


@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_regression_device_fit_matches_jax(solver_env, jax_regression, lane):
    x, y = _regression()
    data = t_group(x, y, 25, dtype=torch.float64, device="cpu")
    kernel = _reg_kernel(tgp)
    args = (_t(kernel.init_theta()),) + tuple(_t(b) for b in kernel.bounds())
    loop: dict = {}
    with t_it.solver_lane_scope(lane):
        got = [o.numpy() for o in t_lik.fit_gpr_device(kernel, True, *args, data, 20, TOL,
                                                       loop_metrics=loop)]
    want = jax_regression[lane]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)   # theta
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)   # final NLL
    assert int(got[2]) == int(want[2]) > 2 and int(got[3]) == int(want[3])
    assert bool(got[4]) == bool(want[4])
    # the loop's evaluations: the initial one and one an eager step
    assert loop["eager_steps"] == int(got[3]) - 1 + loop["masked_evaluations"]


_SIZE = {"gpc": 20, "gpc_mc": 20, "poisson": 20}


def _stack(family):
    """``(x, y)`` of a Laplace family: 3 experts of 20 rows (s = 20 > the
    preconditioner's rank 16)."""
    rng = np.random.default_rng({"gpc": 0, "gpc_mc": 1, "poisson": 2}[family])
    x = rng.normal(size=(60, 2))
    if family == "gpc":
        return x, (x[:, 0] + 0.5 * rng.normal(size=60) > 0).astype(np.float64)
    if family == "gpc_mc":
        return x, np.clip(np.round(x[:, 0] + 1 + 0.3 * rng.normal(size=60)), 0, 2)
    return x, rng.poisson(np.exp(0.5 * np.sin(x.sum(axis=1)) + 1.0)).astype(np.float64)


MAX_ITER = {"gpc": 6, "gpc_mc": 6, "poisson": 5}


def _port_latent_fit(family, loop=None, starts=None, max_iter=None):
    """The port's device fit of ``family`` on the iterative lane (R restart
    lanes with ``starts``), host numpy."""
    x, y = _stack(family)
    data = t_group(x, y, _SIZE[family], dtype=torch.float64, device="cpu")
    kernel = 1.0 * tgp.RBFKernel(1.0)
    lo, hi = (_t(b) for b in kernel.bounds())
    theta0 = _t(kernel.init_theta()) if starts is None else _t(starts)
    with t_it.solver_lane_scope("iterative"):
        if family == "gpc":
            lanes = t_lap.BinaryLaplaceLanes(kernel, data, TOL)
        elif family == "gpc_mc":
            lanes = t_mc.MulticlassLaplaceLanes(kernel, data.x, t_one_hot(data.y, data.mask, 3),
                                                data.mask, TOL)
        else:
            lanes = t_gen.GenericLaplaceLanes(t_gen.PoissonLikelihood(), kernel, data.x, data.y,
                                              data.mask, TOL)
        drive = laplace_device.fit_latent_device if starts is None else \
            laplace_device.fit_latent_device_multistart
        out = drive(lanes, True, theta0, lo, hi, max_iter or MAX_ITER[family], TOL,
                    loop_metrics=loop)
    assert lanes.lane == "iterative"
    return [o.numpy() for o in out], lanes


@pytest.fixture(scope="module", params=["gpc", "gpc_mc", "poisson"])
def jax_latent_fit(request):
    """The JAX package's device fit of the family on the iterative lane
    (one jitted call, ``solver="iterative"``)."""
    family = request.param
    x, y = _stack(family)
    data = j_group(x, y, _SIZE[family])
    kernel = 1.0 * jgp.RBFKernel(1.0)
    lo, hi = kernel.bounds()
    args = (jnp.asarray(kernel.init_theta()), jnp.asarray(lo), jnp.asarray(hi))
    env = {"GP_SOLVER_PRECOND_RANK": "16", "GP_SOLVER_CG_TOL": "1e-12"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if family == "gpc":
            out = j_lap.fit_gpc_device(kernel, TOL, True, *args, data.x, data.y, data.mask,
                                       MAX_ITER[family], solver="iterative")
        elif family == "gpc_mc":
            y1h = j_one_hot(data.y, data.mask, 3)
            out = j_mc.fit_gpc_mc_device(kernel, TOL, True, *args, data.x, y1h, data.mask,
                                         MAX_ITER[family], solver="iterative")
        else:
            out = j_gen.fit_generic_device(j_gen.PoissonLikelihood(), kernel, TOL, True, *args,
                                           data.x, data.y, data.mask, MAX_ITER[family],
                                           solver="iterative")
    finally:
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    return family, [np.asarray(o) for o in out]


def test_laplace_device_fit_on_the_iterative_lane_matches_jax(solver_env, jax_latent_fit):
    family, want = jax_latent_fit
    loop: dict = {}
    got, lanes = _port_latent_fit(family, loop=loop)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)               # theta
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)    # latent modes
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)               # final NLL
    assert int(got[3]) == int(want[3]) > 1 and int(got[4]) == int(want[4])
    assert bool(got[5]) == bool(want[5])
    assert loop["newton_k"] == laplace_device.newton_k(lanes.family, cg=True)
    assert loop["gradient_passes"] == int(got[4])
    # the fit's probes are the per-call draws of the engine's arguments
    assert lanes.probes._draws
    for key, drawn in lanes.probes._draws.items():
        cfg = t_it.solver_config(_SIZE[family])
        if key[0] == "gaussian":
            _, seed, _, batch, rank, s, dtype, device = key
            fresh = t_it.draw_probes(cfg._replace(seed=seed), batch, rank, s, dtype, device)
        else:
            _, seed, shape, dtype, device = key
            fresh = (t_it.draw_rademacher(cfg._replace(seed=seed), shape, dtype, device),)
            drawn = (drawn,)
        for a, b in zip(drawn, fresh):
            assert torch.equal(a, b)


def test_one_newton_iteration_a_step_on_the_cg_lanes(solver_env, monkeypatch):
    """The CG lanes' step size does not change the iterates: one Newton
    iteration a step replays the default step's fit bit for bit."""
    loop_1, loop_k = {}, {}
    default, _ = _port_latent_fit("gpc", loop=loop_k, max_iter=3)
    monkeypatch.setitem(laplace_device.NEWTON_K_CG, "gpc", 1)
    one, _ = _port_latent_fit("gpc", loop=loop_1, max_iter=3)
    for a, b in zip(one, default):
        np.testing.assert_array_equal(a, b)
    assert loop_1["newton_iterations"] == loop_k["newton_iterations"]
    assert loop_1["eager_steps"] > loop_k["eager_steps"]


def test_restart_lanes_share_one_probe_draw(solver_env):
    """R restart lanes of a ``[R * E]`` B stack see the ``[E]`` draw
    repeated (the JAX package's vmapped lanes share their probes), so the
    multi-start's winner is its single-start fit."""
    cfg = t_it.solver_config(20)
    probes = t_it.ProbeSet(experts=3)
    g1, g2 = probes.gaussian(cfg, (6,), 16, 20, torch.float64, "cpu")
    w1, w2 = t_it.draw_probes(cfg, (3,), 16, 20, torch.float64, "cpu")
    assert torch.equal(g1, w1.repeat(2, 1, 1)) and torch.equal(g2, w2.repeat(2, 1, 1))
    assert probes.gaussian(cfg, (6,), 16, 20, torch.float64, "cpu")[0] is g1
    z = probes.rademacher(cfg, (6, 40, cfg.probes), torch.float64, "cpu")
    assert torch.equal(z, t_it.draw_rademacher(cfg, (3, 40, cfg.probes), torch.float64,
                                                "cpu").repeat(2, 1, 1))
    starts = [[1.0, 1.0], [2.0, 0.5]]
    multi, _ = _port_latent_fit("gpc", starts=starts, max_iter=3)
    best = int(multi[7])
    x, y = _stack("gpc")
    data = t_group(x, y, 20, dtype=torch.float64, device="cpu")
    kernel = 1.0 * tgp.RBFKernel(1.0)
    lo, hi = (_t(b) for b in kernel.bounds())
    with t_it.solver_lane_scope("iterative"):
        single = [o.numpy() for o in t_lap.fit_gpc_device(kernel, TOL, True, _t(starts[best]),
                                                          lo, hi, data, 3)]
    np.testing.assert_allclose(multi[0], single[0], rtol=1e-9)
    np.testing.assert_allclose(multi[2], single[2], rtol=1e-12)
    assert int(multi[3]) == int(single[3]) and int(multi[4]) == int(single[4])


@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_estimators_stamp_the_lane_and_the_solver_report(solver_env, lane):
    x, y = _regression()
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: _reg_kernel(tgp))
          .setDatasetSizeForExpert(25).setActiveSetSize(20).setMaxIter(3).setTol(TOL)
          .setOptimizer("device"))
    with t_it.solver_lane_scope(lane):
        m = gp.fit(x, y)
        xc, yc = _stack("gpc")
        c = (tgp.GaussianProcessClassifier(device="cpu").setDatasetSizeForExpert(20)
             .setActiveSetSize(20).setMaxIter(2).setOptimizer("device")).fit(xc, yc)
    for metrics in (m.metrics, c.metrics):
        assert metrics["solver_lane"] == lane and metrics["optimizer"] == "device"
        assert metrics["solver.residual"] < 1e-6 and metrics["solver.cg_iters"] >= 1
        assert metrics["solver.precond_rank"] == 16.0
    if lane == "matfree":
        assert m.metrics["solver.matfree_engaged"] == 1.0


def test_segmented_fit_on_a_cg_lane_resumes_bit_equal(solver_env, tmp_path):
    """A segmented device fit on the iterative lane (the JAX ``segment_meta``,
    which names no lane: the fit's probes are drawn from the seed, so a
    resumed leg sees the same ones), preempted after two saves and
    resumed, lands bit-equal on the one-shot fit."""
    from spark_gp_tpu_torch.resilience import chaos

    x, y = _regression()

    def gp(directory=None):
        est = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: _reg_kernel(tgp))
               .setDatasetSizeForExpert(25).setActiveSetSize(20).setMaxIter(8).setTol(TOL)
               .setOptimizer("device"))
        return est if directory is None else est.setCheckpointDir(str(directory)) \
            .setCheckpointInterval(2)

    with t_it.solver_lane_scope("iterative"):
        one = gp().fit(x, y)
        with chaos.preempt_after_saves(2), pytest.raises(chaos.SimulatedPreemption):
            gp(tmp_path).fit(x, y)
        resumed = gp(tmp_path).fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == 4
    assert resumed.metrics["solver_lane"] == "iterative"
    np.testing.assert_array_equal(resumed.raw_predictor.theta, one.raw_predictor.theta)
    assert resumed.metrics["final_nll"] == one.metrics["final_nll"]
