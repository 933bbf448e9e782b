"""The port's generic-likelihood Laplace core and count regression
(``models/laplace_generic.py``, ``models/gp_poisson.py``) against the JAX
package's, float64 on the CPU.  Bars: each likelihood's ``grad_hess`` and
``log_lik`` within 1e-12 relative; the Bernoulli likelihood through the
generic core equal to the binary classifier's ``batched_neg_logz`` (1e-8;
the JAX package's own cross-check); ``-log Z``, its theta-gradient and
the modes within 1e-8 relative on the exact lane and on the iterative
lane (JAX probes injected, preconditioner rank 16 < s, CG tol 1e-12:
tests/_torch_solver_helpers.py says why); the inverse route of the B
systems (K1's, through its plain version) against the Cholesky route at
1e-10; NB tending to Poisson as the dispersion grows; a Poisson and an
NB fit at n = 200, maxiter 5, against the JAX package's host-optimizer
fits (theta rtol 1e-5, rates rtol 1e-6)."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import laplace_generic as jlg
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import laplace as t_lap
from spark_gp_tpu_torch.models import laplace_generic as tlg
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

TOL = 1e-6

LIKELIHOODS = {
    "poisson": (jlg.PoissonLikelihood(), tlg.PoissonLikelihood()),
    "bernoulli": (jlg.BernoulliLikelihood(), tlg.BernoulliLikelihood()),
    "binomial": (jlg.BinomialLikelihood(5), tlg.BinomialLikelihood(5)),
    "neg_binomial": (jlg.NegativeBinomialLikelihood(2.0), tlg.NegativeBinomialLikelihood(2.0)),
}


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


def _targets(name, n, rng):
    if name == "bernoulli":
        return rng.integers(0, 2, size=n).astype(np.float64)
    if name == "binomial":
        return rng.integers(0, 6, size=n).astype(np.float64)
    return rng.poisson(3.0, size=n).astype(np.float64)


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_grad_hess_and_log_lik_match_jax(name):
    j_lik, t_lik = LIKELIHOODS[name]
    rng = np.random.default_rng(0)
    f = np.concatenate([rng.normal(scale=3.0, size=40), [-30.0, 30.0]])
    y = _targets(name, f.size, rng)
    jg, jh = j_lik.grad_hess(jnp.asarray(f), jnp.asarray(y))
    tg, th = t_lik.grad_hess(torch.as_tensor(f), torch.as_tensor(y))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(t_lik.log_lik(torch.as_tensor(f), torch.as_tensor(y)).numpy(),
                               np.asarray(j_lik.log_lik(jnp.asarray(f), jnp.asarray(y))),
                               rtol=1e-12)
    # the autograd default agrees with the closed form
    ag, ah = tlg.Likelihood.grad_hess(t_lik, torch.as_tensor(f), torch.as_tensor(y))
    np.testing.assert_allclose(ag.numpy(), tg.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ah.numpy(), th.numpy(), rtol=1e-10, atol=1e-12)


def test_likelihood_specs_and_errors():
    assert tlg.BinomialLikelihood(3) == tlg.BinomialLikelihood(3)
    assert tlg.BinomialLikelihood(3) != tlg.BinomialLikelihood(4)
    assert hash(tlg.NegativeBinomialLikelihood(2)) == hash(tlg.NegativeBinomialLikelihood(2.0))
    assert tlg.PoissonLikelihood() != tlg.BernoulliLikelihood()
    with pytest.raises(ValueError, match="trials must be a positive integer"):
        tlg.BinomialLikelihood(0)
    with pytest.raises(ValueError, match="dispersion must be positive"):
        tlg.NegativeBinomialLikelihood(0.0)


def _kernel(m):
    return 1.0 * m.RBFKernel(0.5, 1e-2, 10.0) + m.Const(1e-3) * m.EyeKernel()


def _counts(n=60, seed=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 4.0, n)[:, None]
    return x, rng.poisson(np.exp(1.0 + np.sin(2.0 * x[:, 0]))).astype(np.float64)


def _both(x, y, expert=25):
    """The same stack in both packages: E = 2 experts of s = 30 (one padded
    slot at n = 59)."""
    theta = _kernel(jgp).init_theta() * 1.2
    jd, td = j_group(x, y, expert), t_group(x, y, expert, dtype=torch.float64)
    return theta, jd, td


def test_bernoulli_equals_the_binary_classifier():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 2))
    y = (x[:, 0] - 0.5 * x[:, 1] > 0).astype(np.float64)
    kernel = tgp.RBFKernel(1.0) + tgp.Const(1e-3) * tgp.EyeKernel()
    td = t_group(x, y, 20, dtype=torch.float64)
    theta = torch.as_tensor(kernel.init_theta())
    zeros = torch.zeros_like(td.y)
    gv, gg, gf = tlg.batched_neg_logz_generic(tlg.BernoulliLikelihood(), kernel, TOL, theta,
                                               td.x, td.y, td.mask, zeros)
    bv, bg, bf = t_lap.batched_neg_logz(kernel, TOL, theta, td, zeros)
    np.testing.assert_allclose(gv.item(), bv.item(), rtol=1e-8)
    assert _rel(gg.numpy(), bg.numpy()) <= 1e-8 and _rel(gf.numpy(), bf.numpy()) <= 1e-8


def _compare(name, x, y, lane=None):
    j_lik, t_lik = LIKELIHOODS[name]
    theta, jd, td = _both(x, y)
    assert tuple(td.x.shape) == (2, 30, 1) and td.mask.sum().item() == x.shape[0]
    if lane is not None:
        jgp.ops.iterative.set_solver_lane(lane)
        t_it.set_solver_lane(lane)
    # the JAX package's jitted objective, keyed by the solver lane
    jv, jg, jf = jlg._generic_vag_impl(j_lik, _kernel(jgp), TOL, jnp.asarray(theta), jd.x, jd.y,
                                       jd.mask, jnp.zeros_like(jd.y),
                                       solver=jgp.ops.iterative.solver_jit_key())
    iterations = tlg.laplace_generic_mode.iterations
    tv, tg, tf = tlg.batched_neg_logz_generic(t_lik, _kernel(tgp), TOL, torch.as_tensor(theta),
                                              td.x, td.y, td.mask, torch.zeros_like(td.y))
    assert tlg.laplace_generic_mode.iterations > iterations
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-8
    assert _rel(tf.numpy(), jf) <= 1e-8


@pytest.mark.parametrize("name", ["poisson", "neg_binomial"])
def test_neg_logz_matches_jax_exact_lane(name):
    x, y = _counts(59)
    _compare(name, x, y)


@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_neg_logz_matches_jax_iterative_lane(solver_env, lane):
    x, y = _counts(59)
    _compare("poisson", x, y, lane)


def test_inverse_route_matches_cholesky_route(monkeypatch):
    x, y = _counts(59)
    theta, _, td = _both(x, y)
    lik, kernel = tlg.PoissonLikelihood(), _kernel(tgp)

    def run():
        return tlg.batched_neg_logz_generic(lik, kernel, TOL, torch.as_tensor(theta), td.x, td.y,
                                            td.mask, torch.zeros_like(td.y))

    chol = run()
    monkeypatch.setattr(spd_linalg, "kernel_applies", lambda k: True)
    inv = run()
    np.testing.assert_allclose(inv[0].item(), chol[0].item(), rtol=1e-10)
    assert _rel(inv[1].numpy(), chol[1].numpy()) <= 1e-10


def test_negative_binomial_tends_to_poisson():
    x, y = _counts(59)
    theta, _, td = _both(x, y)

    def run(lik):
        return tlg.batched_neg_logz_generic(lik, _kernel(tgp), TOL, torch.as_tensor(theta),
                                            td.x, td.y, td.mask, torch.zeros_like(td.y))

    pv, pg, pf = run(tlg.PoissonLikelihood())
    gaps = []
    for r in (1e2, 1e4, 1e6):
        nv, ng, nf = run(tlg.NegativeBinomialLikelihood(r))
        # NB's log p differs from Poisson's by the y-only constant it drops
        # plus O(1/r) terms; the modes and the gradient converge
        gaps.append((_rel(nf.numpy(), pf.numpy()), _rel(ng.numpy(), pg.numpy())))
    assert gaps[-1][0] < 1e-5 and gaps[-1][1] < 1e-4
    assert gaps[0][0] > gaps[1][0] > gaps[2][0]


def _count_gp(m, dispersion=None, **kw):
    gp = (m.GaussianProcessPoissonRegression(**kw) if dispersion is None
          else m.GaussianProcessNegativeBinomialRegression(dispersion, **kw))
    return (
        gp.setKernel(lambda: 1.0 * m.RBFKernel(0.5, 1e-2, 10.0))
        .setDatasetSizeForExpert(50)
        .setActiveSetSize(30)
        .setMaxIter(5)
    )


@pytest.mark.parametrize("dispersion", [None, 2.0])
def test_count_fit_matches_jax(dispersion):
    x, y = _counts(200, seed=42)
    j_gp = _count_gp(jgp, dispersion)
    t_gp = _count_gp(tgp, dispersion, device="cpu")
    if dispersion is not None:
        assert t_gp.getDispersion() == dispersion
    j_model = j_gp.setOptimizer("host").fit(x, y)
    t_model = t_gp.fit(x, y)
    np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta,
                               rtol=1e-5)
    xt = np.linspace(0.1, 3.9, 25)[:, None]
    np.testing.assert_allclose(t_model.predict_rate(xt), j_model.predict_rate(xt), rtol=1e-6)
    mean, var = t_model.predict_latent(xt)
    np.testing.assert_allclose(t_model.predict(xt), np.exp(mean + 0.5 * np.maximum(var, 0.0)))
    m = t_model.metrics
    assert m["newton_iterations"] > 0 and m["objective_calls"] == m["lbfgs_nfev"] + 1
    assert m["gram_cache_engaged"] == 1.0 and m["num_experts"] == 4
    assert t_model.raw_predictor.u1 is None


def _device_fit_on_the_iterative_lane(gp, x, y):
    """The device fit on the iterative lane: a fitted model, its latent
    families' B systems on the CG engine."""
    with t_it.solver_lane_scope("iterative"):
        model = gp.setOptimizer("device").setMaxIter(3).fit(x, y)
    assert model.metrics["solver_lane"] == "iterative" and model.metrics["optimizer"] == "device"
    assert np.all(np.isfinite(model.predict_rate(x[:5])))


def _fit_distributed_at_world_size_one(gp, x, y):
    """``fit_distributed`` (item 6a) of a one-rank stack of counts fits the
    same theta as ``fit`` on the same rows; negative counts are refused."""
    from spark_gp_tpu_torch.parallel.distributed import distribute_global_experts

    s = gp._dataset_size_for_expert
    model = gp.setMaxIter(3).fit_distributed(distribute_global_experts(x, y, s, device="cpu"))
    np.testing.assert_array_equal(model.raw_predictor.theta, gp.fit(x, y).raw_predictor.theta)
    assert np.all(np.isfinite(model.predict_rate(x[:5])))
    with pytest.raises(ValueError, match="non-negative integer counts"):
        gp.fit_distributed(distribute_global_experts(x, -y - 1.0, s, device="cpu"))


@pytest.mark.parametrize("call, error, message", [
    (lambda gp, x, y: gp.fit(x, y - 0.5), ValueError, "non-negative integer counts"),
    (lambda gp, x, y: gp.fit(x, -y - 1.0), ValueError, "non-negative integer counts"),
    (lambda gp, x, y: _device_fit_on_the_iterative_lane(gp, x, y), None, None),
    (lambda gp, x, y: _fit_distributed_at_world_size_one(gp, x, y), None, None),
])
def test_count_estimator_surface(call, error, message):
    x, y = _counts(30)
    if error is None:  # a call that fits (its own checks inside)
        call(_count_gp(tgp, device="cpu"), x, y)
        return
    with pytest.raises(error, match=message):
        call(_count_gp(tgp, device="cpu"), x, y)
