"""The port's product-of-experts predictor (``models/poe.py``) against the
JAX package's, float64 on the CPU, at a fixed theta: the mean and the
variance of all five modes within rtol 1e-9 and atol 1e-12, on a ragged
multi-expert stack, on a single expert (where poe, gpoe and bcm are the
exact GP posterior), on a test set streamed in chunks with a padded last
one, and on a stack whose singular expert gram the jitter ladder
repairs; the estimator's ``poe_predictor`` at a fitted model's theta;
and the mode's resolution through the aggregation plane."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import aggregation as j_agg
from spark_gp_tpu.models import poe as j_poe
from spark_gp_tpu_torch.models import aggregation as t_agg
from spark_gp_tpu_torch.models import poe as t_poe
from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException

MODES = ("poe", "gpoe", "bcm", "rbcm", "healed")


def _kernel(m):
    return 1.0 * m.RBFKernel(0.7, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0.0, 1.0)


def _check(jp, tp, x_test):
    jm, jv = jp.predict_with_var(x_test)
    tm, tv = tp.predict_with_var(x_test)
    assert tm.dtype == np.float64 and tm.shape == (x_test.shape[0],)
    np.testing.assert_allclose(tm, jm, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tv, jv, rtol=1e-9, atol=1e-12)
    return tm, tv


def _pair(x, y, s, mode, kernel=_kernel, theta=None):
    jk, tk = kernel(jgp), kernel(tgp)
    theta = jk.init_theta() if theta is None else theta
    return (j_poe.make_poe_predictor(jk, theta, x, y, s, mode=mode),
            t_poe.make_poe_predictor(tk, theta, x, y, s, mode=mode, device="cpu"))


@pytest.mark.parametrize("case", ["multi", "single", "far"])
@pytest.mark.parametrize("mode", MODES)
def test_modes_match_jax(case, mode):
    rng = np.random.default_rng(0)
    n, s = (34, 12) if case != "single" else (20, 20)  # multi: E = 3, 2 padded slots
    x = rng.normal(size=(n, 2))
    y = np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=n)
    # far: test points in a void, where every expert reverts to the prior
    x_test = rng.normal(size=(7, 2)) + (40.0 if case == "far" else 0.0)
    jp, tp = _pair(x, y, s, mode, theta=_kernel(jgp).init_theta() * 1.1)
    assert tp.mode == mode and tp._chol.shape == ((1 if case == "single" else 3), s, s)
    _check(jp, tp, x_test)


def test_streamed_test_set_matches_one_block():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 2))
    y = np.sin(x.sum(axis=1))
    x_test = rng.normal(size=(57, 2))
    jp, tp = _pair(x, y, 10, "healed")
    one_block = tp.predict_with_var(x_test)
    jp._PREDICT_CHUNK_ELEMS = tp._PREDICT_CHUNK_ELEMS = 40 * 7  # 7-point chunks, ragged tail
    tm, tv = _check(jp, tp, x_test)
    np.testing.assert_allclose(tm, one_block[0], rtol=1e-12)
    np.testing.assert_allclose(tv, one_block[1], rtol=1e-12)


def test_singular_gram_repaired_like_jax():
    """A duplicated-row expert under a noise-free kernel has a singular
    gram: the ladder repairs that expert only, as the JAX package's; a
    gram no rung can repair (NaN) raises."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(24, 2))
    x[1::2] = x[1]  # expert 1 of 2: every row the same
    y = np.sin(x.sum(axis=1))
    kernel = lambda m: 1.0 * m.RBFKernel(0.7, 1e-6, 10)  # noqa: E731
    jp, tp = _pair(x, y, 12, "rbcm", kernel=kernel)
    _check(jp, tp, rng.normal(size=(5, 2)))
    healthy = torch.linalg.cholesky(tp._chol[0] @ tp._chol[0].mT)
    np.testing.assert_allclose(tp._chol[0].numpy(), healthy.numpy(), rtol=1e-10)
    with pytest.raises(NotPositiveDefiniteException):
        t_poe.make_poe_predictor(tgp.RBFKernel(0.7), np.array([0.7]), np.full((12, 2), np.nan),
                                 np.zeros(12), 12, device="cpu")


def test_estimator_poe_predictor_matches_jax():
    """At a fitted model's theta, with the mode resolved through the
    engaged policy; an unknown mode and a bad shape are refused."""
    from spark_gp_tpu.data import make_synthetics

    x, y = make_synthetics(n=300)

    def gp(m, **kw):
        return (m.GaussianProcessRegression(**kw)
                .setKernel(lambda: 1.0 * m.RBFKernel(0.1, 1e-6, 10) + m.WhiteNoiseKernel(0.5, 0, 1))
                .setDatasetSizeForExpert(100).setActiveSetSize(50).setMaxIter(5).setSeed(13))

    jgpr, tgpr = gp(jgp), gp(tgp, device="cpu")
    jm, tm = jgpr.fit(x, y), tgpr.fit(x, y)
    x_test = np.linspace(-1.5, 1.5, 40)[:, None]
    previous = j_agg.set_agg_policy("gpoe"), t_agg.set_agg_policy("gpoe")
    try:
        jp, tp = jgpr.poe_predictor(x, y, jm), tgpr.poe_predictor(x, y, tm)
    finally:
        j_agg.set_agg_policy(previous[0])
        t_agg.set_agg_policy(previous[1])
    assert tp.mode == jp.mode == "gpoe"
    np.testing.assert_allclose(tp.theta.numpy(), jp.theta, rtol=1e-5)
    tm_, tv_ = tp.predict_with_var(x_test)
    jm_, jv_ = jp.predict_with_var(x_test)
    np.testing.assert_allclose(tm_, jm_, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv_, jv_, rtol=1e-5)
    assert tgpr.poe_predictor(x, y).mode == "rbcm"  # the documented default
    with pytest.raises(ValueError, match="unknown PoE mode"):
        tgpr.poe_predictor(x, y, mode="blended")
    with pytest.raises(ValueError, match=r"x must be \[N, p\]"):
        tgpr.poe_predictor(np.zeros(5), np.zeros(5))
