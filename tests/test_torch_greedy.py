"""The port's greedy (Seeger) provider against the JAX package's, float64
on the CPU: the same selected indices (exactly) and winning deltas (1e-8
relative) at (n = 300, p = 3, m = 16) and on a stack with masked slots and
duplicated rows (tied scores: the lowest index wins in both); the flat
delta-profile warning at the JAX package's calibration; the ELBO guard; a
greedy regression fit against the JAX package's host-optimizer fit (theta
rtol 1e-5, the same active rows, predictions rtol 1e-6, as
test_torch_gpr.py); and the Year-MSD stand-in row for row."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.data import load_year_msd as j_load_year_msd
from spark_gp_tpu.models import greedy as jgreedy
from spark_gp_tpu_torch.data import load_year_msd
from spark_gp_tpu_torch.models import greedy as tgreedy

J_SELECT = jax.jit(jgreedy._greedy_select, static_argnums=(0, 1))


def _kernel(m):
    return 1.0 * m.RBFKernel(0.7) + m.WhiteNoiseKernel(0.1, 0.0, 1.0) \
        + m.Const(1e-3) * m.EyeKernel()


def _data(n, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    return x, np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=n)


def _cases():
    x, y = _data(300, 3, 0)
    plain = (x, y, np.ones(300), 16, 123)
    # masked slots and duplicated rows: exact ties between candidates
    xm, ym = _data(120, 2, 1)
    xm[60:80], ym[60:80] = xm[20:40], ym[20:40]
    mask = np.ones(120)
    mask[[3, 17, 41, 99, 100]] = 0.0
    return {"n300_m16": plain, "masked_ties": (xm, ym, mask, 24, 7)}


@pytest.mark.parametrize("case", ["n300_m16", "masked_ties"])
def test_selection_matches_jax(case):
    x, y, mask, m, first = _cases()[case]
    theta = _kernel(jgp).init_theta() * 1.1
    _, j_idx, j_delta = J_SELECT(_kernel(jgp), m, jnp.asarray(theta), jnp.asarray(x),
                                 jnp.asarray(y), jnp.asarray(mask), jnp.asarray(first, jnp.int32))
    put = torch.as_tensor
    _, t_idx, t_delta = tgreedy._greedy_core(_kernel(tgp), m, put(theta), put(x), put(y),
                                             put(mask), torch.tensor(first))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert np.isnan(t_delta[0].item()) and np.isnan(float(j_delta[0]))
    np.testing.assert_allclose(t_delta.numpy()[1:], np.asarray(j_delta)[1:], rtol=1e-8)
    assert not np.isin(t_idx.numpy(), np.flatnonzero(mask == 0)).any()


def test_active_set_is_the_jax_packages_rows():
    x, y, _, m, _ = _cases()["n300_m16"]
    theta = _kernel(jgp).init_theta()
    j_rows = jgreedy.greedy_active_set(m, x, y, _kernel(jgp), theta, 5)
    t_rows = tgp.GreedilyOptimizingActiveSetProvider()(m, x, y, _kernel(tgp), theta, 5,
                                                       device="cpu")
    np.testing.assert_array_equal(t_rows, j_rows)


@pytest.mark.parametrize("deltas", [
    np.full(12, 2.0),                          # flat: ratio 1, warns
    np.linspace(3.0, 3.3, 15),                 # rising: warns
    np.geomspace(4.0, 0.5, 15),                # decaying: no warning
    np.array([3.0, 2.0, np.nan, 1.0, 0.5]),    # too short: None
    np.concatenate([[np.nan], -np.ones(11)]),  # head <= 0: None
])
def test_flat_profile_warning_matches_jax(deltas, caplog):
    with caplog.at_level(logging.WARNING, logger="spark_gp_tpu_torch"):
        ratio = tgreedy.warn_on_flat_delta_profile(deltas)
    j_ratio = jgreedy.warn_on_flat_delta_profile(deltas)
    assert ratio == j_ratio
    warned = any("not decaying" in r.getMessage() for r in caplog.records
                 if r.name == "spark_gp_tpu_torch")
    assert warned == (ratio is not None and ratio >= 0.95)


def test_elbo_with_greedy_needs_white_noise():
    x, y = _data(60, 2, 3)
    gp = tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0)) \
        .setSigma2(0.0).setObjective("elbo") \
        .setActiveSetProvider(tgp.GreedilyOptimizingActiveSetProvider())
    with pytest.raises(ValueError, match="needs nonzero white noise"):
        gp.fit(x, y)
    # from_stack (item 6a) over a stack that is whole here selects the rows
    # the host-row provider does, from the same seed row: a stack of every
    # row as the only expert has its rows in point order
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    gp = gp.setSigma2(1e-2)
    kernel, theta = gp._get_kernel(), gp._get_kernel().init_theta()
    stack = group_for_experts(x, y, x.shape[0], device="cpu")
    provider = tgp.GreedilyOptimizingActiveSetProvider()
    np.testing.assert_array_equal(
        provider.from_stack(8, stack, kernel, theta, 0, None),
        provider(8, x, y, kernel, theta, 0, device="cpu"))


def _gp(m, **kw):
    return (
        m.GaussianProcessRegression(**kw)
        .setKernel(lambda: 1.0 * m.RBFKernel(0.5) + m.WhiteNoiseKernel(0.1, 0.0, 1.0))
        .setDatasetSizeForExpert(50)
        .setActiveSetSize(12)
        .setActiveSetProvider(m.GreedilyOptimizingActiveSetProvider())
        .setMaxIter(8)
        .setSeed(13)
    )


def test_greedy_fit_matches_jax():
    x, y = _data(200, 2, 4)
    xt, _ = _data(40, 2, 5)
    j_model = _gp(jgp).setOptimizer("host").fit(x, y)
    t_model = _gp(tgp, device="cpu").fit(x, y)
    np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta,
                               rtol=1e-5)
    np.testing.assert_array_equal(t_model.raw_predictor.active, j_model.raw_predictor.active)
    j_mean, j_var = j_model.predict_with_var(xt)
    t_mean, t_var = t_model.predict_with_var(xt)
    np.testing.assert_allclose(t_mean, j_mean, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_mean)))
    np.testing.assert_allclose(t_var, j_var, rtol=1e-6)


def test_year_msd_standin_is_the_jax_packages():
    x, y = load_year_msd(n=400)
    jx, jy = j_load_year_msd(None, n=400)
    assert x.shape == (400, 90)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
