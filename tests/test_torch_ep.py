"""The port's EP engine and classifier (``models/ep.py``,
``models/gpc_ep.py``) against the JAX package's, float64 on the CPU.
Bars: ``log_ndtr`` over [-40, 10] within 5e-11 relative and 1e-15
absolute of the JAX package's (its own accuracy) and 1e-13 of scipy's,
the pdf / cdf ratio within 5e-8 of JAX's (its log Phi error) and 1e-12
of scipy's; one site update,
the converged sites and ``-log Z_EP`` with its theta-gradient at
(E = 2, s = 12, one padded slot) within 1e-8 relative, the same sweep
count; one iris one-vs-rest fold fitted with the host optimizer: theta*
rtol 1e-5 and both ``predict_proba`` modes within 1e-6 (as the binary
classifier's fit test); the inverse route of the B systems (K1's, through
its plain version) against the Cholesky route at 1e-10."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.data import load_iris as j_load_iris
from spark_gp_tpu.models import ep as jep
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu.utils.validation import OneVsRest as JOneVsRest
from spark_gp_tpu.utils.validation import kfold_indices
from spark_gp_tpu_torch.models import ep as tep
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group
from spark_gp_tpu_torch.utils.validation import OneVsRest

TOL = 1e-6
J_NEG_LOGZ = jax.jit(jep.batched_neg_logz_ep, static_argnums=(0, 1))
J_FIT_SITES = jax.jit(jep.ep_fit_sites, static_argnums=(5,))
J_MARGINALS = jax.jit(jep._posterior_marginals)
J_SITE_UPDATE = jax.jit(jep._site_update)
J_LOG_NDTR = jax.jit(jax.scipy.special.log_ndtr)
J_RATIO = jax.jit(jep._npdf_over_cdf)


def _kernel(m):
    return 1.0 * m.RBFKernel(1.0) + m.Const(1e-3) * m.EyeKernel()


def _problem():
    """23 points in 2-d: E = 2 experts of s = 12, one padded slot."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(23, 2))
    y = (x[:, 0] + 0.3 * rng.normal(size=23) > 0).astype(np.float64)
    return x, y


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


def test_log_ndtr_matches_jax_on_both_tails():
    """The JAX package's float64 ``log_ndtr`` is within 2e-11 relative of
    scipy's below z = 3 and keeps only its absolute accuracy (< 1e-16)
    above, where ``log Phi`` is tiny; the port's is scipy's to 1e-13."""
    from scipy.special import log_ndtr

    z = np.linspace(-40.0, 10.0, 2001)
    ref = np.asarray(J_LOG_NDTR(jnp.asarray(z)))
    got = tep._log_ndtr(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-11, atol=1e-15)
    np.testing.assert_allclose(got, log_ndtr(z), rtol=1e-13)
    # the ratio exp(log pdf - log Phi) carries log Phi's absolute error
    # (JAX's: ~1.6e-8 at z = -40) as a relative one
    ratio = tep._npdf_over_cdf(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(ratio, np.asarray(J_RATIO(jnp.asarray(z))),
                               rtol=5e-8)
    np.testing.assert_allclose(ratio, np.exp(-0.5 * (z * z + tep._LOG2PI) - log_ndtr(z)),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def stacks():
    x, y = _problem()
    theta = _kernel(jgp).init_theta() * 1.3
    jd, td = j_group(x, y, 12), t_group(x, y, 12, dtype=torch.float64)
    assert tuple(td.x.shape) == (2, 12, 2) and td.mask.sum().item() == 23
    jk = jax.vmap(lambda xe, me: jgp.ops.linalg.masked_kernel_matrix(
        _kernel(jgp).gram(jnp.asarray(theta), xe), me))(jd.x, jd.mask)
    tk = tgp.kernels.base.masked_gram_stack(_kernel(tgp), torch.as_tensor(theta), td.x, td.mask)
    y_pm = (2.0 * td.y - 1.0) * td.mask
    return {"theta": theta, "jd": jd, "td": td, "jk": jk, "tk": tk, "y_pm": y_pm}


def test_site_update_matches_jax(stacks):
    rng = np.random.default_rng(2)
    tau = rng.uniform(0.1, 2.0, size=(2, 12)) * stacks["td"].mask.numpy()
    nu = rng.normal(size=(2, 12)) * stacks["td"].mask.numpy()
    j_sd, j_mu, _ = J_MARGINALS(stacks["jk"], jnp.asarray(tau), jnp.asarray(nu))
    t_sd, t_mu, _, _ = tep._posterior_marginals(stacks["tk"], torch.as_tensor(tau),
                                                torch.as_tensor(nu))
    assert _rel(t_sd.numpy(), j_sd) <= 1e-10 and _rel(t_mu.numpy(), j_mu) <= 1e-10
    y_pm, mask = stacks["y_pm"], stacks["td"].mask
    j_new = J_SITE_UPDATE(jnp.asarray(y_pm.numpy()), jnp.asarray(mask.numpy()),
                             jnp.asarray(tau), jnp.asarray(nu), j_sd, j_mu)
    t_new = tep._site_update(y_pm, mask, torch.as_tensor(tau), torch.as_tensor(nu), t_sd, t_mu)
    for t, j in zip(t_new, j_new):
        assert _rel(t.numpy(), j) <= 1e-10
    assert t_new[0][1, 11].item() == 0.0 and t_new[1][1, 11].item() == 0.0  # padded slot


def test_fit_sites_match_jax(stacks):
    y_pm, mask = stacks["y_pm"], stacks["td"].mask
    zeros = np.zeros((2, 12))
    j_tau, j_nu, j_sweeps = J_FIT_SITES(stacks["jk"], jnp.asarray(y_pm.numpy()),
                                        jnp.asarray(mask.numpy()), jnp.asarray(zeros),
                                        jnp.asarray(zeros), TOL)
    before = tep.ep_fit_sites.sweeps
    t_tau, t_nu, t_sweeps = tep.ep_fit_sites(stacks["tk"], y_pm, mask,
                                             torch.zeros(2, 12, dtype=torch.float64),
                                             torch.zeros(2, 12, dtype=torch.float64), TOL)
    assert t_sweeps == int(j_sweeps) and tep.ep_fit_sites.sweeps - before == t_sweeps
    assert 1 < t_sweeps < 60
    assert _rel(t_tau.numpy(), j_tau) <= 1e-8 and _rel(t_nu.numpy(), j_nu) <= 1e-8


@pytest.mark.parametrize("warm", [False, True])
def test_neg_logz_and_gradient_match_jax(stacks, warm):
    jd, td, theta = stacks["jd"], stacks["td"], stacks["theta"]
    zeros = np.zeros((2, 12))
    sites = (zeros, zeros)
    if warm:  # start from sites converged at another theta
        _, _, (tau, nu) = J_NEG_LOGZ(_kernel(jgp), TOL, jnp.asarray(theta * 0.8), jd,
                                     (jnp.asarray(zeros), jnp.asarray(zeros)))
        sites = (np.asarray(tau), np.asarray(nu))
    jv, jg, (jt, jn) = J_NEG_LOGZ(_kernel(jgp), TOL, jnp.asarray(theta), jd,
                                  tuple(jnp.asarray(s) for s in sites))
    calls = tep.batched_neg_logz_ep.calls
    tv, tg, (tt, tn) = tep.batched_neg_logz_ep(_kernel(tgp), TOL, torch.as_tensor(theta), td,
                                               tuple(torch.tensor(s) for s in sites))
    assert tep.batched_neg_logz_ep.calls == calls + 1
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-8
    assert _rel(tt.numpy(), jt) <= 1e-8 and _rel(tn.numpy(), jn) <= 1e-8


def test_inverse_route_matches_cholesky_route(stacks, monkeypatch):
    """The B systems through K1's route (its plain version here) against
    the Cholesky route: value and theta-gradient."""
    td, theta = stacks["td"], torch.as_tensor(stacks["theta"])
    zeros = (torch.zeros(2, 12, dtype=torch.float64),) * 2
    chol = tep.batched_neg_logz_ep(_kernel(tgp), TOL, theta, td, zeros)
    monkeypatch.setattr(spd_linalg, "kernel_applies", lambda k: True)
    inv = tep.batched_neg_logz_ep(_kernel(tgp), TOL, theta, td, zeros)
    np.testing.assert_allclose(inv[0].item(), chol[0].item(), rtol=1e-10)
    assert _rel(inv[1].numpy(), chol[1].numpy()) <= 1e-10


def _ep_gpc(m, **kw):
    return m.GaussianProcessEPClassifier(**kw).setDatasetSizeForExpert(20) \
        .setActiveSetSize(30).setMaxIter(15)


def test_iris_fold_matches_jax():
    """The first CV fold of examples/iris.py --ep: one-vs-rest over three
    EP problems (E = 7, s = 20 each)."""
    x, y = j_load_iris()
    train, test = next(iter(kfold_indices(x.shape[0], 10, seed=13)))
    j_ovr = JOneVsRest(lambda: _ep_gpc(jgp).setOptimizer("host")).fit(x[train], y[train])
    t_ovr = OneVsRest(lambda: _ep_gpc(tgp, device="cpu")).fit(x[train], y[train])
    for t_model, j_model in zip(t_ovr.models_, j_ovr.models_):
        assert isinstance(t_model, tgp.GaussianProcessEPClassificationModel)
        np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta,
                                   rtol=1e-5)
        for averaged in (False, True):
            np.testing.assert_allclose(t_model.predict_proba(x[test], averaged=averaged),
                                       j_model.predict_proba(x[test], averaged=averaged),
                                       atol=1e-6)
        m = t_model.metrics
        assert (m["num_experts"], m["expert_size"]) == (7, 20)
        assert m["gram_cache_engaged"] == 0.0 and m["ep_sweeps"] >= m["objective_calls"] > 0
    np.testing.assert_array_equal(t_ovr.predict(x[test]), j_ovr.predict(x[test]))
