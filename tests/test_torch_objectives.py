"""The port's LOO and ELBO training objectives (``models/loo.py``,
``models/sgpr.py``, ``setObjective``, ``gp.loo``) against the JAX
package's, float64 on the CPU, on the same seeded inputs.  Bars: the LOO
moments within 1e-10 on a padded stack, the LOO objective and gradient
within 1e-9 and against central differences (1e-6), the deleted-point
oracle (1e-8), ``gp.loo`` within 1e-10; the ELBO within 1e-10 and its
gradient within 1e-8, equal to the exact marginal when the inducing set
is the data (5e-3, from the ``K_mm`` jitter) and below it otherwise,
finite in float32; the fits' final objective and theta within 1e-5 and
predictions within 1e-6 of the JAX package's.  K1's branch forced on the
CPU (its plain forward and its own VJP) against the Cholesky branch, one
forward a LOO evaluation and none in the backward."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import loo as j_loo
from spark_gp_tpu.models import sgpr as j_sgpr
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.data import make_synthetics
from spark_gp_tpu_torch.models import loo as t_loo
from spark_gp_tpu_torch.models import sgpr as t_sgpr
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

P = 2


def _kernel(m):
    return 1.0 * m.RBFKernel(0.7, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0.0, 1.0)


def _elbo_kernel(m):
    """The ELBO's kernel has no trainable noise: sigma2 is the noise."""
    return 1.0 * m.RBFKernel(0.7, 1e-6, 10)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    return x, np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=n)


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


# --- LOO -------------------------------------------------------------------


def test_loo_moments_match_jax_on_a_padded_stack():
    """37 points in experts of 10: E = 4, s = 10, three padded slots."""
    x, y = _data(37)
    jd, td = j_group(x, y, 10), t_group(x, y, 10, dtype=torch.float64)
    assert float(td.mask.sum()) == 37 and td.mask.numel() == 40
    theta = _kernel(jgp).init_theta() * 1.2
    want = jax.jit(lambda t: j_loo.loo_moments(_kernel(jgp), t, jd.x, jd.y, jd.mask))(
        jnp.asarray(theta))
    got = t_loo.loo_moments(_kernel(tgp), torch.as_tensor(theta), td.x, td.y, td.mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    pad = td.mask == 0
    np.testing.assert_array_equal(got[1][pad].numpy(), 1.0)  # var of a padded slot
    np.testing.assert_array_equal(got[0][pad].numpy(), 0.0)  # residual 0, y 0


def _t_loo_vag(theta, td):
    return make_value_and_grad(_kernel(tgp), td, objective="loo")(theta)


def test_loo_objective_and_gradient_match_jax_and_differences():
    x, y = _data(37, seed=1)
    jd, td = j_group(x, y, 10), t_group(x, y, 10, dtype=torch.float64)
    theta = _kernel(jgp).init_theta() * np.array([1.1, 0.9, 1.3])
    jv, jg = jax.jit(jax.value_and_grad(lambda t: j_loo.batched_loo_nll(_kernel(jgp), t, jd)))(
        jnp.asarray(theta))
    tv, tg = _t_loo_vag(theta, td)
    np.testing.assert_allclose(tv, float(jv), rtol=1e-9)
    assert _rel(tg, jg) <= 1e-9
    h = 1e-6
    fd = np.array([(_t_loo_vag(theta + h * e, td)[0] - _t_loo_vag(theta - h * e, td)[0]) / (2 * h)
                   for e in np.eye(theta.size)])
    assert _rel(tg, fd) <= 1e-6


def _brute_force_loo(kernel, theta, xs, ys):
    """Delete each point of one expert and predict it from the rest."""
    k_full = kernel.gram(torch.as_tensor(theta), torch.as_tensor(xs)).numpy()
    n = xs.shape[0]
    mus, variances = np.empty(n), np.empty(n)
    for i in range(n):
        keep = [j for j in range(n) if j != i]
        k_rest = k_full[np.ix_(keep, keep)]
        k_cross = k_full[i, keep]
        mus[i] = k_cross @ np.linalg.solve(k_rest, ys[keep])
        variances[i] = k_full[i, i] - k_cross @ np.linalg.solve(k_rest, k_cross)
    return mus, variances


@pytest.mark.parametrize("n,s", [(24, 24), (37, 10)])
def test_loo_matches_deleted_point_oracle(n, s):
    x, y = _data(n, seed=2)
    kernel = _kernel(tgp)
    theta = kernel.init_theta()
    got = t_loo.loo_diagnostics(kernel, theta, x, y, s, torch.float64, "cpu")
    e = t_group(x, y, s).num_experts
    for j in range(e):
        members = np.arange(j, n, e)
        mus, variances = _brute_force_loo(kernel, theta, x[members], y[members])
        np.testing.assert_allclose(got["loo_mean"][members], mus, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(got["loo_var"][members], variances, rtol=1e-8, atol=1e-8)
    resid = y - got["loo_mean"]
    np.testing.assert_allclose(
        got["loo_log_density"],
        -0.5 * (np.log(2 * np.pi * got["loo_var"]) + resid**2 / got["loo_var"]), rtol=1e-8)


def test_gp_loo_matches_jax_diagnostics():
    x, y = _data(37, seed=3)
    gp = tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: _kernel(tgp)) \
        .setDatasetSizeForExpert(10)
    got = gp.loo(x, y)  # at the initial theta, noise-augmented kernel
    kernel = _kernel(jgp) + jgp.Const(1e-3) * jgp.EyeKernel()
    want = j_loo.loo_diagnostics(kernel, kernel.init_theta(), x, y, 10)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-10, atol=1e-12)


def test_loo_through_k1_branch_matches_cholesky_branch_and_counts(monkeypatch):
    """The card's branch forced on the CPU: K1's wrapper (its plain
    forward here) and its own VJP, against the Cholesky branch; one
    forward a LOO evaluation, none in the backward."""
    x, y = _data(37, seed=4)
    td = t_group(x, y, 10, dtype=torch.float64)
    theta = _kernel(tgp).init_theta() * 0.8
    v_chol, g_chol = _t_loo_vag(theta, td)
    calls = []
    forward = spd_linalg._forward

    def counted(k):
        calls.append(tuple(k.shape))
        return forward(k)

    monkeypatch.setattr(spd_linalg, "kernel_applies", lambda k: True)
    monkeypatch.setattr(spd_linalg, "_forward", counted)
    v_k1, g_k1 = _t_loo_vag(theta, td)
    np.testing.assert_allclose(v_k1, v_chol, rtol=1e-12)
    assert _rel(g_k1, g_chol) <= 1e-10
    assert calls == [(4, 10, 10)]


# --- ELBO ------------------------------------------------------------------


def _elbo_pair(x, y, s, active, sigma2, theta):
    kernel_j, kernel_t = _elbo_kernel(jgp), _elbo_kernel(tgp)
    jv, jg = jax.jit(jax.value_and_grad(lambda t: j_sgpr.batched_elbo_nll(
        kernel_j, t, j_group(x, y, s), jnp.asarray(active), sigma2)))(jnp.asarray(theta))
    tv, tg = make_value_and_grad(kernel_t, t_group(x, y, s, dtype=torch.float64),
                                 objective="elbo", extra=(active, sigma2))(theta)
    return (float(jv), np.asarray(jg)), (tv, tg)


@pytest.mark.parametrize("n,s", [(30, 30), (34, 12)])
def test_elbo_matches_jax(n, s):
    x, y = _data(n, seed=5)
    active = x[np.random.default_rng(6).choice(n, size=8, replace=False)]
    theta = _elbo_kernel(jgp).init_theta() * np.array([1.2, 0.8])
    (jv, jg), (tv, tg) = _elbo_pair(x, y, s, active, 1e-2, theta)
    np.testing.assert_allclose(tv, jv, rtol=1e-10)
    assert _rel(tg, jg) <= 1e-8


def _exact_log_marginal(x, y, sigma2):
    kernel = _elbo_kernel(tgp)
    knn = kernel.gram(torch.as_tensor(kernel.init_theta()), torch.as_tensor(x)).numpy()
    cov = knn + sigma2 * np.eye(x.shape[0])
    _, logdet = np.linalg.slogdet(cov)
    return -0.5 * (x.shape[0] * np.log(2 * np.pi) + logdet + y @ np.linalg.solve(cov, y))


def test_elbo_equals_exact_marginal_when_inducing_is_data():
    x, y = _data(25, seed=7)
    theta = _elbo_kernel(tgp).init_theta()
    got = -t_sgpr.batched_elbo_nll(_elbo_kernel(tgp), torch.as_tensor(theta),
                                   t_group(x, y, 25, dtype=torch.float64),
                                   torch.as_tensor(x), 1e-2).item()
    exact = _exact_log_marginal(x, y, 1e-2)
    assert got <= exact + 1e-8
    np.testing.assert_allclose(got, exact, atol=5e-3)


def test_elbo_lower_bounds_exact_marginal():
    x, y = _data(40, seed=8)
    exact = _exact_log_marginal(x, y, 1e-2)
    data = t_group(x, y, 20, dtype=torch.float64)
    theta = torch.as_tensor(_elbo_kernel(tgp).init_theta())
    elbos = [-t_sgpr.batched_elbo_nll(_elbo_kernel(tgp), theta, data, torch.as_tensor(x[:m]),
                                      1e-2).item() for m in (4, 8, 16)]
    assert all(e <= exact + 1e-8 for e in elbos)
    assert elbos[0] <= elbos[1] + 1e-8 <= elbos[2] + 2e-8  # nested sets tighten


def test_elbo_finite_in_float32():
    """The Synthetics ELBO config's objective at init theta, float32 on the
    CPU over a k-means inducing set: value and gradient finite (the
    square-then-whiten form NaNs here)."""
    x, y = make_synthetics(n=1500)
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: 1.0 * tgp.RBFKernel(
        0.1, 1e-6, 10)).setActiveSetProvider(tgp.KMeansActiveSetProvider()).setSigma2(1e-2)
        .setSeed(13))
    kernel = gp._get_kernel()
    active = gp._select_active(kernel, kernel.init_theta(), x, y, torch.device("cpu"))
    data = t_group(x, y, 100, dtype=torch.float32)
    value, grad = make_value_and_grad(kernel, data, objective="elbo",
                                      extra=(active, 1e-2))(kernel.init_theta())
    assert np.isfinite(value) and np.all(np.isfinite(grad))


# --- fits ------------------------------------------------------------------


def _estimator(m, objective, **kw):
    make = _elbo_kernel if objective == "elbo" else _kernel
    return (m.GaussianProcessRegression(**kw).setKernel(lambda: make(m))
            .setDatasetSizeForExpert(50).setActiveSetSize(40).setSigma2(1e-2)
            .setMaxIter(15).setSeed(7).setObjective(objective))


@pytest.fixture(scope="module")
def fit_data():
    x, y = _data(300, seed=9)
    return x, y, np.random.default_rng(10).normal(size=(40, P))


@pytest.mark.parametrize("objective", ["loo", "elbo"])
def test_fit_matches_jax(fit_data, objective):
    x, y, xt = fit_data
    j_model = _estimator(jgp, objective).setOptimizer("host").fit(x, y)
    t_model = _estimator(tgp, objective, device="cpu").fit(x, y)
    np.testing.assert_allclose(t_model.metrics["final_nll"],
                               j_model.instr.metrics["final_nll"], rtol=1e-5)
    np.testing.assert_allclose(t_model.raw_predictor.theta, np.asarray(j_model.raw_predictor.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(t_model.predict(xt), j_model.predict(xt), rtol=1e-6, atol=1e-8)
    assert t_model.metrics["objective"] == objective
    assert t_model.metrics["gram_cache_engaged"] == float(objective != "elbo")


class _FreshRows(tgp.ActiveSetProvider):
    """Different rows on every call: a fit that selected again at theta*
    would build its PPA on the second call's rows."""

    uses_fit_outputs = True

    def __init__(self):
        self.calls = []

    def __call__(self, active_set_size, x, y, kernel, theta_opt, seed):
        rows = np.asarray(x)[len(self.calls)::3][:active_set_size]
        self.calls.append(np.asarray(theta_opt).copy())
        return rows


def test_elbo_ppa_uses_the_preselected_set(fit_data):
    x, y, _ = fit_data
    provider = _FreshRows()
    gp = _estimator(tgp, "elbo", device="cpu").setActiveSetProvider(provider)
    model = gp.fit(x, y)
    assert len(provider.calls) == 1
    np.testing.assert_array_equal(provider.calls[0], gp._get_kernel().init_theta())
    np.testing.assert_array_equal(model.raw_predictor.active, x[0::3][:40])
    # the marginal objective selects after the optimization, at theta*
    provider = _FreshRows()
    model = copy.copy(gp).setObjective("marginal").setActiveSetProvider(provider).fit(x, y)
    np.testing.assert_array_equal(provider.calls[0], model.raw_predictor.theta)


def test_set_objective_rejects_unknown():
    with pytest.raises(ValueError, match="unknown objective"):
        tgp.GaussianProcessRegression().setObjective("map")


@pytest.mark.parametrize("scale", [(1.0, 1.0), (2.0, 2.0)])
def test_float32_elbo_holds_the_card_bars(scale):
    """The Synthetics ELBO config on 1,500 rows in float32 against float64
    on the CPU, within 1e-5 of the value and 1e-4 of the largest gradient
    component, at the initial theta and at twice it.  Each trace term
    ``tr K_nn / 2 sigma2`` is 7.6e4 here, 180 times the bound at the
    initial theta.  Here the float64 sums leave about 2e-8 / 1e-7.  The
    float32 form that summed the two traces apart missed the bars at both
    points (3.3e-5 / 1.2e-4 at the initial theta, 9.9e-7 / 5.9e-4 at twice
    it, in one thread), and so did the residual trace alone in float32
    (1.7e-5 / 1.2e-4, 1.8e-6 / 5.1e-4)."""
    x, y = make_synthetics(n=1500)
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: 1.0 * tgp.RBFKernel(
        0.1, 1e-6, 10)).setActiveSetProvider(tgp.KMeansActiveSetProvider()).setSigma2(1e-2)
        .setSeed(13))
    kernel = gp._get_kernel()
    active = gp._select_active(kernel, kernel.init_theta(), x, y, torch.device("cpu"))
    theta = kernel.init_theta() * np.asarray(scale)
    sides = [make_value_and_grad(kernel, t_group(x, y, 100, dtype=dtype), objective="elbo",
                                 extra=(active, 1e-2))(theta)
             for dtype in (torch.float32, torch.float64)]
    (v32, g32), (v64, g64) = sides
    assert abs(v32 - v64) / abs(v64) <= 1e-5
    assert _rel(g32, g64) <= 1e-4
