"""The port's theta-invariant gram cache (``kernels/base.py``): float64 on
the CPU.  ``gram_from_cache(theta, prepare(x))`` equals ``gram(theta, x)``
bit for bit on every family that has ``prepare`` and matches a dense
numpy oracle (rtol 1e-12); ARD kernels and composites with an ARD child
have none; ``GP_GRAM_CACHE=0`` turns it off; a cached objective never
calls ``kernel.gram``; cached and uncached objectives (regression,
binary and multiclass Laplace) agree (1e-12); and
the fits record whether the cache engaged.  The JAX package's own float64
gram-cache parity tests fail in some environments (ROADMAP.md queue 3),
so the oracles here are numpy, not the JAX package."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu_torch as tgp
from spark_gp_tpu_torch.kernels import base
from spark_gp_tpu_torch.models import laplace, laplace_mc, likelihood
from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.parallel.experts import group_for_experts


def _sq(x):
    return np.sum((x[..., :, None, :] - x[..., None, :, :]) ** 2, axis=-1)


def _matern(nu2):
    def oracle(t, x):
        a = np.sqrt(nu2) * np.sqrt(np.maximum(_sq(x), 1e-24)) / t[0]
        poly = {1: 1.0, 3: 1.0 + a, 5: 1.0 + a + a * a / 3.0}[nu2]
        return poly * np.exp(-a)
    return oracle


# family -> (kernel, theta, dense numpy oracle of its gram)
FAMILIES = {
    "rbf": (tgp.RBFKernel(), [0.8], lambda t, x: np.exp(-_sq(x) / (2 * t[0] ** 2))),
    "matern12": (tgp.Matern12Kernel(), [0.9], _matern(1)),
    "matern32": (tgp.Matern32Kernel(), [0.9], _matern(3)),
    "matern52": (tgp.Matern52Kernel(), [0.9], _matern(5)),
    "rq": (tgp.RationalQuadraticKernel(), [0.9, 1.7],
           lambda t, x: (1 + _sq(x) / (2 * t[1] * t[0] ** 2)) ** -t[1]),
    "dot": (tgp.DotProductKernel(), [0.6], lambda t, x: t[0] ** 2 + x @ x.swapaxes(-1, -2)),
    "poly": (tgp.PolynomialKernel(2), [0.7], lambda t, x: (x @ x.swapaxes(-1, -2) + t[0]) ** 2),
    "scaled_sum_noise": (
        1.3 * tgp.RBFKernel() + tgp.Const(0.5) * tgp.Matern32Kernel()
        + tgp.WhiteNoiseKernel(0.2, 0, 1),
        [1.3, 0.8, 0.9, 0.2],
        lambda t, x: t[0] * np.exp(-_sq(x) / (2 * t[1] ** 2)) + 0.5 * _matern(3)(t[2:3], x)
        + t[3] * np.eye(x.shape[-2])),
}


def _x(e=2, s=7, p=3, seed=0):
    return np.random.default_rng(seed).normal(size=(e, s, p))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gram_from_cache_is_the_gram(family):
    kernel, theta, oracle = FAMILIES[family]
    x = _x()
    xt, tt = torch.as_tensor(x), torch.as_tensor(theta, dtype=torch.float64)
    cache = base.prepare_gram_cache(kernel, xt)
    assert cache is not None and base.supports_gram_cache(kernel)
    cached = kernel.gram_from_cache(tt, cache)
    assert torch.equal(cached, kernel.gram(tt, xt))
    np.testing.assert_allclose(cached.numpy(), oracle(np.asarray(theta), x), rtol=1e-12,
                               atol=1e-14)
    mask = torch.as_tensor(np.array([[1.0] * 7, [1.0] * 5 + [0.0] * 2]))
    assert torch.equal(base.masked_gram_stack(kernel, tt, xt, mask, cache),
                       base.masked_gram_stack(kernel, tt, xt, mask))


def test_eye_cache_is_a_zero_byte_carrier():
    x = torch.as_tensor(_x())
    cache = tgp.EyeKernel().prepare(x)
    assert tuple(cache.shape) == (2, 7, 0) and cache.dtype == torch.float64
    assert torch.equal(tgp.EyeKernel().gram_from_cache(torch.zeros(0), cache),
                       torch.eye(7, dtype=torch.float64).expand(2, 7, 7))


@pytest.mark.parametrize("kernel", [
    tgp.ARDRBFKernel(3),
    1.0 * tgp.ARDRBFKernel(3) + tgp.Const(1.0) * tgp.EyeKernel(),
    tgp.RBFKernel() + tgp.ARDRBFKernel(3),
    tgp.Const(2.0) * tgp.ARDRBFKernel(3),
], ids=["ard", "scaled_ard_plus_noise", "sum_with_ard_child", "const_ard"])
def test_no_cache_without_an_invariant(kernel):
    assert kernel.prepare is None and not base.supports_gram_cache(kernel)
    assert base.prepare_gram_cache(kernel, torch.as_tensor(_x())) is None


def test_gram_from_cache_refuses_a_kernel_without_one():
    with pytest.raises(NotImplementedError, match="prepare is None"):
        tgp.ARDRBFKernel(3).gram_from_cache(torch.ones(3, dtype=torch.float64), None)


def test_knob_turns_the_cache_off(monkeypatch):
    kernel = tgp.RBFKernel() + tgp.Const(1e-3) * tgp.EyeKernel()
    x = torch.as_tensor(_x())
    assert base.gram_cache_enabled() and base.prepare_gram_cache(kernel, x) is not None
    monkeypatch.setenv("GP_GRAM_CACHE", "0")
    assert not base.gram_cache_enabled()
    assert base.prepare_gram_cache(kernel, x) is None
    # the structure is still there: only the knob is off
    assert kernel.prepare is not None


def _regression(n=40, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    return x, np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=n)


@pytest.mark.parametrize("family", ["rbf", "rq", "poly", "scaled_sum_noise"])
def test_cached_objectives_match_uncached(family):
    """``batched_nll``, the binary ``batched_neg_logz`` and the multiclass
    ``batched_neg_logz_mc``: value and gradient within 1e-12 with and
    without the cache, and no call of ``kernel.gram`` (or of any child's)
    once a cache is live."""
    kernel, theta, _ = FAMILIES[family]
    kernel = kernel + tgp.Const(1e-3) * tgp.EyeKernel()
    theta = torch.as_tensor(list(theta), dtype=torch.float64)
    x, y = _regression()
    data = group_for_experts(x, y, 13, dtype=torch.float64)
    cache = base.prepare_gram_cache(kernel, data.x)
    labels = group_for_experts(x, (y > 0).astype(np.float64), 13, dtype=torch.float64)

    def nll(c):
        t = theta.clone().requires_grad_(True)
        value = likelihood.batched_nll(kernel, t, data, c)
        return value.item(), torch.autograd.grad(value, t)[0]

    def neg_logz(c):
        value, grad, _ = laplace.batched_neg_logz(kernel, 1e-10, theta, labels,
                                                  torch.zeros_like(labels.y), c)
        return value.item(), grad

    y1h = _one_hot_masked(labels.y, labels.mask, 2)

    def neg_logz_mc(c):
        value, grad, _ = laplace_mc.batched_neg_logz_mc(
            kernel, 1e-10, theta, labels.x, y1h, labels.mask, torch.zeros_like(y1h), c)
        return value.item(), grad

    want = [nll(None), neg_logz(None), neg_logz_mc(None)]
    calls = []
    classes = {type(k) for k in _leaves(kernel)}
    originals = {cls: cls.gram for cls in classes}
    try:
        for cls in classes:
            cls.gram = lambda self, *a, _o=originals[cls]: calls.append(1) or _o(self, *a)
        got = [nll(cache), neg_logz(cache), neg_logz_mc(cache)]
    finally:
        for cls, fn in originals.items():
            cls.gram = fn
    assert calls == []
    for (v, g), (wv, wg) in zip(got, want):
        np.testing.assert_allclose(v, wv, rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=1e-12, atol=1e-14)


def _leaves(kernel):
    for child in ("k1", "k2", "kernel"):
        if hasattr(kernel, child):
            yield from _leaves(getattr(kernel, child))
    yield kernel


@pytest.mark.parametrize("lane,kernel,engaged", [
    ("exact", lambda: tgp.RBFKernel(), 1.0),
    ("iterative", lambda: tgp.RBFKernel(), 1.0),
    ("matfree", lambda: tgp.RBFKernel(), 0.0),
    ("exact", lambda: 1.0 * tgp.ARDRBFKernel(3), 0.0),
    ("matfree", lambda: 1.0 * tgp.ARDRBFKernel(3), 0.0),
], ids=["exact-rbf", "iterative-rbf", "matfree-rbf", "exact-ard", "matfree-ard"])
def test_regression_fit_records_engagement(lane, kernel, engaged):
    """The fit builds the cache when the kernel has an invariant, except
    on the matfree lane with a kernel that streams (the lane never builds
    the ``[E, s, s]`` block); an ARD kernel on the matfree lane runs the
    materialized iterative lane, still without a cache."""
    x, y = _regression()
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(kernel)
          .setDatasetSizeForExpert(20).setActiveSetSize(10).setMaxIter(2))
    try:
        model = gp.setSolverLane(lane).fit(x, y)
    finally:
        t_it.set_solver_lane(None)
    assert model.metrics["gram_cache_engaged"] == engaged


def test_classifier_fit_records_engagement(monkeypatch):
    x, y = _regression()
    labels = (y > 0).astype(np.float64)

    def fit():
        return tgp.GaussianProcessClassifier(device="cpu").setDatasetSizeForExpert(20) \
            .setActiveSetSize(10).setMaxIter(3).fit(x, labels)

    cached = fit()
    monkeypatch.setenv("GP_GRAM_CACHE", "0")
    uncached = fit()
    assert (cached.metrics["gram_cache_engaged"], uncached.metrics["gram_cache_engaged"]) \
        == (1.0, 0.0)
    np.testing.assert_allclose(cached.raw_predictor.theta, uncached.raw_predictor.theta,
                               rtol=1e-12)
    np.testing.assert_allclose(cached.predict_proba(x), uncached.predict_proba(x), rtol=1e-12)
