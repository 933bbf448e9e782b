"""The port's on-device L-BFGS-B (``optimize/lbfgs_device.py``) and the
regression fit under ``setOptimizer("device")`` against the JAX
package's ``lbfgs_device``, float64 on the CPU, on the same seeded
inputs.  On the CPU the port runs its state machine's step eagerly: the
code a CUDA graph captures on the card.  Bars: the analytic problems'
theta within 1e-10 relative with ``n_iter``, ``n_fev`` and ``stalled``
equal; the Cauchy point within 1e-12 of the JAX package's (and on the
projected path, as its path oracle checks); the interior step equal to
``-B^-1 g`` (1e-8); a frozen multi-start lane keeps its own diagnostics;
the regression fit's theta within 1e-6 and final NLL within 1e-9
relative for each objective, and the batched multi-start's winner and
restart NLLs (1e-9): the port's estimator fit against the JAX package's
device fit of the same operands.  The regression problem is an airfoil subset with
standardized columns: on the raw targets (~120 dB, sigma2 1e-3) the
grams are so ill-conditioned that the two packages' float64 Cholesky
factorizations already differ near 1e-8 in one NLL, and thirty
iterations amplify that past any parity bar."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.optimize import lbfgs_device as J
from spark_gp_tpu_torch.data import load_airfoil
from spark_gp_tpu_torch.ops import cuda_lib
from spark_gp_tpu_torch.optimize import lbfgs_device as T

F64 = torch.float64


def per_lane(vag_one):
    """A lanes objective from a one-lane one, ``theta [h] -> (f, g [h])``,
    called lane by lane."""

    def vag(theta):
        out = [vag_one(theta[r]) for r in range(theta.shape[0])]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    return vag


def _quad(target):
    tj, tt = jnp.asarray(target), torch.tensor(target, dtype=F64)
    return ((lambda th, aux: (jnp.sum((th - tj) ** 2), 2 * (th - tj), aux)),
            (lambda th: (torch.sum((th - tt) ** 2), 2 * (th - tt))))


def _rosen_j(th, aux):
    a, b = th[0], th[1]
    g = jnp.stack([-2 * (1 - a) - 400 * a * (b - a ** 2), 200 * (b - a ** 2)])
    return (1 - a) ** 2 + 100 * (b - a ** 2) ** 2, g, aux


def _rosen_t(th):
    a, b = th[0], th[1]
    g = torch.stack([-2 * (1 - a) - 400 * a * (b - a ** 2), 200 * (b - a ** 2)])
    return (1 - a) ** 2 + 100 * (b - a ** 2) ** 2, g


INF2 = [np.inf, np.inf]
PROBLEMS = {
    # the minimum outside the box lands on its boundary
    "box_quadratic": (*_quad([-3.0, 7.0]), [0.5, 0.5], [0.0, 0.0], [1.0, 5.0], 100, 1e-10),
    "rosenbrock": (_rosen_j, _rosen_t, [-1.2, 1.0], [-np.inf, -np.inf], INF2, 300, 1e-14),
    # an adversarial gradient: no trial passes Armijo, the search stalls
    "stalled": ((lambda th, aux: (jnp.sum(th), -jnp.ones_like(th), aux)),
                (lambda th: (torch.sum(th), -torch.ones_like(th))),
                [1.0, 2.0], [-np.inf, -np.inf], INF2, 50, 1e-12),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Every analytic problem through the JAX loop, in one jitted program."""

    def run_all(args):
        out = {}
        for name, (fj, _, _, _, _, max_iter, tol) in PROBLEMS.items():
            x0, lo, hi = args[name]
            out[name] = J.lbfgs_minimize_device(fj, x0, lo, hi, jnp.zeros(()),
                                                max_iter=jnp.asarray(max_iter),
                                                tol=jnp.asarray(tol))
        return out

    args = {name: tuple(jnp.asarray(v) for v in p[2:5]) for name, p in PROBLEMS.items()}
    return jax.jit(run_all)(args)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_analytic_problems_match_the_jax_loop(name, jax_runs):
    _, ft, x0, lo, hi, max_iter, tol = PROBLEMS[name]
    theta_j, _, _, it_j, fev_j, st_j = jax_runs[name]
    theta, _, n_iter, n_fev, stalled = T.lbfgs_minimize_device(
        per_lane(ft), torch.tensor(x0, dtype=F64), torch.tensor(lo, dtype=F64),
        torch.tensor(hi, dtype=F64), max_iter=max_iter, tol=tol)
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_j), rtol=1e-10, atol=1e-300)
    assert (int(n_iter), int(n_fev), bool(stalled)) == (int(it_j), int(fev_j), bool(st_j))
    assert bool(stalled) == (name == "stalled")


def test_cauchy_point_matches_jax_and_the_path_oracle():
    """The generalized Cauchy point equals the JAX package's and is the
    first local minimizer of the model along the projected path (a dense
    sampling of ``m(P(x - t g))``, no structure shared with either).  The
    port takes the trials as lanes; the JAX function is vmapped."""
    rng = np.random.default_rng(3)
    cauchy_j = jax.jit(jax.vmap(J._cauchy_point))
    for h in (5,):
        n = 12
        a = rng.normal(size=(n, h, h))
        b_mat = a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(h)
        x, g = rng.normal(size=(n, h)), rng.normal(size=(n, h))
        lower = x - rng.uniform(0.05, 3.0, size=(n, h))
        upper = x + rng.uniform(0.05, 3.0, size=(n, h))
        args = (x, g, lower, upper, b_mat)
        zj, fixed_j = cauchy_j(*(jnp.asarray(v) for v in args))
        zt, fixed_t = T._cauchy_point(*(torch.tensor(v) for v in args))
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(fixed_t.numpy(), np.asarray(fixed_j))
        ts = np.linspace(0.0, 20.0, 100001)
        for i in range(n):
            z_c = zt[i].numpy()
            zs = np.clip(x[i][None] - ts[:, None] * g[i][None], lower[i], upper[i]) - x[i][None]
            vals = zs @ g[i] + 0.5 * np.einsum("ti,ij,tj->t", zs, b_mat[i], zs)
            rising = np.nonzero(np.diff(vals) > 0)[0]
            first_min = vals[rising[0]] if rising.size else vals[-1]
            np.testing.assert_allclose(g[i] @ z_c + 0.5 * z_c @ b_mat[i] @ z_c, first_min,
                                       atol=1e-4)
            assert np.min(np.max(np.abs(zs - z_c[None]), axis=1)) < 1e-3


def test_interior_step_is_the_quasi_newton_step():
    """With no active bound the proposal is ``-B^-1 g`` for the dense B the
    history builds, and that B is the JAX package's."""
    rng = np.random.default_rng(5)
    h, m_hist = 4, 10
    s_hist, y_hist = np.zeros((m_hist, h)), np.zeros((m_hist, h))
    for i in range(3):
        s = rng.normal(size=h)
        y = s + 0.3 * rng.normal(size=h)
        s_hist[i], y_hist[i] = s, (y if s @ y > 0 else -y)
    x, g = rng.normal(size=h), rng.normal(size=h)
    inf = torch.full((h,), np.inf, dtype=F64)
    three = torch.tensor([3], dtype=torch.int32)
    hist = (torch.tensor(s_hist)[None], torch.tensor(y_hist)[None], three, three)
    d = T._lbfgsb_direction(torch.tensor(x)[None], torch.tensor(g)[None], -inf, inf, *hist, m_hist)
    b_t = T._dense_b_from_history(*hist, m_hist)[0].numpy()
    b_j = np.asarray(jax.jit(J._dense_b_from_history, static_argnums=4)(
        jnp.asarray(s_hist), jnp.asarray(y_hist), jnp.asarray(3, jnp.int32),
        jnp.asarray(3, jnp.int32), m_hist))
    np.testing.assert_allclose(b_t, b_j, rtol=1e-12)
    np.testing.assert_allclose(d[0].numpy(), -np.linalg.solve(b_t, g), rtol=1e-8)


def test_frozen_multistart_lane_keeps_its_own_diagnostics():
    """Lane 0 starts at the optimum, lane 1 far away: lane 0 ends at its
    own iteration (no line search: one evaluation), unstalled, while lane
    1 iterates on; both lanes' diagnostics are the JAX vmap's, and the
    winner is lane 0 with its own."""
    fj, ft = _quad([2.0, -1.0])
    target = np.array([2.0, -1.0])
    theta0 = np.stack([target, target + 40.0])
    runs = jax.jit(jax.vmap(lambda t0: J.lbfgs_minimize_device(
        fj, t0, jnp.asarray([-jnp.inf] * 2), jnp.asarray([jnp.inf] * 2), jnp.zeros(()),
        max_iter=jnp.asarray(100), tol=jnp.asarray(1e-10))))(jnp.asarray(theta0))
    inf = torch.full((2,), np.inf, dtype=F64)
    thetas, _, iters, fevs, stalls = T.lbfgs_minimize_device_lanes(
        per_lane(ft), torch.tensor(theta0), -inf, inf, max_iter=100, tol=1e-10)
    assert int(iters[1]) > int(iters[0]) and int(iters[0]) <= 2 and int(fevs[0]) == 1
    assert not bool(stalls[0]) and not bool(stalls[1])
    np.testing.assert_array_equal(iters.numpy(), np.asarray(runs[3]))
    np.testing.assert_array_equal(fevs.numpy(), np.asarray(runs[4]))
    np.testing.assert_allclose(thetas.numpy(), np.asarray(runs[0]), rtol=1e-10, atol=1e-12)
    _, _, it_b, fev_b, st_b, f_all, best = T.lbfgs_minimize_device_multistart(
        per_lane(ft), torch.tensor(theta0), -inf, inf, max_iter=100, tol=1e-10)
    assert int(best) == 0 and int(it_b) == int(iters[0]) and int(fev_b) == 1
    assert not bool(st_b) and f_all.shape == (2,)


def _airfoil():
    x, y = load_airfoil()
    idx = np.random.default_rng(0).choice(len(x), 200, replace=False)
    x, y = x[idx], y[idx]
    return (x - x.mean(0)) / x.std(0), (y - y.mean()) / y.std()


def _gp(objective, restarts=1):
    gp = (tgp.GaussianProcessRegression(device="cpu")
          .setKernel(lambda: 1.0 * tgp.ARDRBFKernel(5, 1.0, 1e-3, 100.0))
          .setDatasetSizeForExpert(50).setActiveSetSize(40).setSigma2(1e-2).setMaxIter(30)
          .setSeed(3).setOptimizer("device").setObjective(objective))
    return gp.setNumRestarts(restarts) if restarts > 1 else gp


def _jax_operands(x, y):
    """The JAX package's estimator operands of the same configuration: its
    kernel, bounds and grouped stack (its device fit is called directly,
    the PPA build is not the subject here)."""
    from spark_gp_tpu.parallel.experts import group_for_experts

    gp = (jgp.GaussianProcessRegression()
          .setKernel(lambda: 1.0 * jgp.ARDRBFKernel(5, 1.0, 1e-3, 100.0)).setSigma2(1e-2))
    kernel = gp._get_kernel()
    lower, upper = kernel.bounds()
    data = group_for_experts(x, y, 50)
    return (kernel, gp._use_log_space(kernel), jnp.asarray(lower), jnp.asarray(upper),
            data.x, data.y, data.mask, jnp.asarray(30), jnp.asarray(1e-6))


@pytest.mark.parametrize("objective", ["marginal", "loo", "elbo"])
def test_device_regression_fit_matches_the_jax_package(objective):
    """The port's estimator fit under ``setOptimizer("device")`` against the
    JAX package's device fit (``models/likelihood.fit_gpr_device``) of the
    same stack, kernel and start; the ELBO on the inducing set the port's
    fit selected."""
    from spark_gp_tpu.models.likelihood import fit_gpr_device

    x, y = _airfoil()
    mt = _gp(objective).fit(x, y)
    kernel, log_space, lower, upper, jx, jy, jmask, max_iter, tol = _jax_operands(x, y)
    extra = (jnp.asarray(mt.raw_predictor.active), 1e-2) if objective == "elbo" else ()
    theta_j, f_j, it_j, fev_j, stalled_j = fit_gpr_device(
        kernel, log_space, jnp.asarray(kernel.init_theta()), lower, upper, jx, jy, jmask,
        max_iter, tol, extra, objective=objective)
    np.testing.assert_allclose(mt.raw_predictor.theta, np.asarray(theta_j), rtol=1e-6)
    np.testing.assert_allclose(mt.metrics["final_nll"], float(f_j), rtol=1e-9)
    assert mt.metrics["lbfgs_iters"] == int(it_j) and mt.metrics["lbfgs_nfev"] == int(fev_j)
    assert mt.metrics["optimizer"] == "device" and mt.metrics["lbfgs_stalled"] == float(stalled_j)
    # the CPU runs the step eagerly, one step per evaluation of the lane
    assert mt.metrics["device_opt.eager_steps"] == mt.metrics["lbfgs_nfev"] - 1
    assert mt.metrics["device_opt.captures"] == 0.0


def test_batched_multistart_matches_the_jax_package():
    """The port's batched multi-start against the JAX package's device fit
    from each restart's starting point (its vmapped multi-start runs each
    lane as the standalone loop does, ``test_frozen_...`` above): the same
    winner, the restart NLLs within 1e-9 and the winner's theta within
    1e-6."""
    from spark_gp_tpu.models.likelihood import fit_gpr_device

    x, y = _airfoil()
    gp = _gp("marginal", restarts=3)
    mt = gp.fit(x, y)
    kernel, log_space, lower, upper, jx, jy, jmask, max_iter, tol = _jax_operands(x, y)
    runs = [fit_gpr_device(kernel, log_space, jnp.asarray(t0), lower, upper, jx, jy, jmask,
                           max_iter, tol)
            for t0 in gp._restart_theta_batch(gp._get_kernel())]
    nlls = [float(run[1]) for run in runs]
    best = int(np.argmin(nlls))
    assert mt.metrics["best_restart"] == best and mt.metrics["num_restarts"] == 3
    for r in range(3):
        np.testing.assert_allclose(mt.metrics[f"restart_{r}_nll"], nlls[r], rtol=1e-9)
    np.testing.assert_allclose(mt.raw_predictor.theta, np.asarray(runs[best][0]), rtol=1e-6)


def test_optimizer_setting_and_lanes():
    """``"auto"`` stays the host optimizer; ``"device"`` fits on the
    iterative lane, where the whole loop runs on the CG engine; an unknown
    name is refused."""
    x, y = _airfoil()
    gp = tgp.GaussianProcessRegression(device="cpu").setDatasetSizeForExpert(50) \
        .setActiveSetSize(20).setMaxIter(2)
    assert gp.setOptimizer("auto")._resolved_optimizer() == "host"
    assert gp.setOptimizer("device")._resolved_optimizer() == "device"
    with pytest.raises(ValueError, match="optimizer must be"):
        gp.setOptimizer("gpu")
    gp.setSolverLane("iterative")
    try:
        model = gp.fit(x, y)
    finally:
        gp.setSolverLane("exact")
    assert model.metrics["optimizer"] == "device" and model.metrics["solver_lane"] == "iterative"
    assert model.metrics["lbfgs_iters"] <= 2 and model.metrics["solver.residual"] < 1e-3
    assert np.isfinite(model.metrics["final_nll"])
    assert gp.setOptimizer("host").fit(x, y).metrics["lbfgs_iters"] <= 2


def test_graph_launch_tally_counts_replays():
    """A wrapper called outside a capture counts its launch; a capture's
    tally turns into launches only when the graph replays, in the wrapper's
    counter and in the telemetry the run journal reads."""
    from spark_gp_tpu_torch.obs.runtime import telemetry

    def wrapper():
        return None

    def counted():
        return telemetry.snapshot()["counters"].get("kernel.launches.test_kernel", 0.0)

    wrapper.launches = 0
    before = counted()
    cuda_lib.record_launch(wrapper, "test_kernel")
    assert wrapper.launches == 1
    with cuda_lib.capture_tally() as tally:
        cuda_lib.record_launch(wrapper, "test_kernel")  # no stream captures here
    assert tally == {} and wrapper.launches == 2
    cuda_lib.count_replays({"test_kernel": [wrapper, 2, 0.0, 0.0]}, 3)
    assert wrapper.launches == 8 and counted() - before == 8
