"""The port's product, theta-override, ARD Matern, ARD rational-quadratic,
periodic and spectral-mixture kernels against the JAX package's, float64
on the CPU, on the same seeded inputs at ``[E = 3, s = 17, p = 3]``:
``gram`` / ``cross`` / ``diag`` / ``self_diag`` within 1e-12 relative,
the same ``init_theta``, ``bounds`` and ``n_hypers``, the autograd
gradient of ``sum(W * gram)`` against JAX's within 1e-10, the same
answers to ``supports_gram_cache`` / ``supports_matfree``; the product's
gram from its cache; the white-noise rejection; finite ARD-Matern
gradients at coincident rows."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.kernels import base as jbase
from spark_gp_tpu_torch.kernels import base as tbase

E, S, P = 3, 17, 3


def _override(m, base):
    return (jbase if m is jgp else tbase).ThetaOverrideKernel(
        base(m), base(m).init_theta() * 1.3)


KERNELS = {
    "product_rbf_periodic": lambda m: m.RBFKernel(0.8) * m.PeriodicKernel(1.3, 0.9),
    "product_rbf_matern12": lambda m: m.RBFKernel(0.8) * m.Matern12Kernel(1.1),
    "product_scaled_ard": lambda m: 2.0 * m.ARDRBFKernel(P, 0.6) * m.RationalQuadraticKernel(),
    "ard_matern32": lambda m: m.ARDMatern32Kernel(P, 0.7),
    "ard_matern52": lambda m: m.ARDMatern52Kernel(np.array([0.5, 1.0, 1.5])),
    "ard_rq": lambda m: m.ARDRationalQuadraticKernel(P, 0.8, 1.5, alpha_upper=20.0),
    "periodic": lambda m: m.PeriodicKernel(1.3, 0.9, lower=[0.1, 1e-3], upper=10.0),
    "spectral_mixture": lambda m: m.SpectralMixtureKernel(P, 2),
    "spectral_mixture_set": lambda m: m.SpectralMixtureKernel(
        P, 2, weights=[0.3, 0.7], means=np.full((2, P), 0.4), scales=np.full((2, P), 0.2)),
    "theta_override_sum": lambda m: _override(
        m, lambda mm: 1.0 * mm.RBFKernel(0.5) + mm.WhiteNoiseKernel(0.1, 0, 1)),
    "theta_override_sm": lambda m: _override(
        m, lambda mm: mm.SpectralMixtureKernel(P, 2) + mm.Const(1e-3) * mm.EyeKernel()),
}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.max(np.abs(want)), 1.0))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_values_theta_layout_and_capabilities_match_jax(name):
    jk, tk = KERNELS[name](jgp), KERNELS[name](tgp)
    assert tk.n_hypers == jk.n_hypers
    np.testing.assert_array_equal(tk.init_theta(), jk.init_theta())
    for t_b, j_b in zip(tk.bounds(), jk.bounds()):
        np.testing.assert_array_equal(t_b, np.asarray(j_b))
    assert tbase.supports_gram_cache(tk) == jbase.supports_gram_cache(jk)
    assert tbase.supports_matfree(tk) == jbase.supports_matfree(jk)
    theta = jk.init_theta() * np.linspace(0.8, 1.2, jk.n_hypers)
    x, xt = _x(0, (E, S, P)), _x(1, (E, 5, P))
    tt, jt = torch.as_tensor(theta), jnp.asarray(theta)
    tx, txt = torch.as_tensor(x), torch.as_tensor(xt)

    @jax.jit
    @jax.vmap
    def jax_values(xe, xte):  # one expert; one compile for the four
        return (jk.gram(jt, xe), jk.cross(jt, xte, xe), jk.diag(jt, xe),
                jk.self_diag(jt, xte))

    want = jax_values(jnp.asarray(x), jnp.asarray(xt))
    got = (tk.gram(tt, tx), tk.cross(tt, txt, tx), tk.diag(tt, tx), tk.self_diag(tt, txt))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gram_gradient_matches_jax(name):
    """The autograd gradient of ``sum(W * gram)`` over the stack against
    ``jax.grad`` of the same sum over the experts, within 1e-10."""
    jk, tk = KERNELS[name](jgp), KERNELS[name](tgp)
    theta = jk.init_theta() * np.linspace(0.9, 1.1, jk.n_hypers)
    x, w = _x(2, (E, S, P)), _x(3, (E, S, S))
    tt = torch.as_tensor(theta).requires_grad_(True)
    (g_t,) = torch.autograd.grad(torch.sum(torch.as_tensor(w) * tk.gram(tt, torch.as_tensor(x))),
                                 tt)
    g_j = jax.jit(jax.grad(lambda t: jnp.sum(jnp.asarray(w) * jax.vmap(jk.gram, (None, 0))(
        t, jnp.asarray(x)))))(jnp.asarray(theta))
    _close(g_t.numpy(), g_j, 1e-10)


@pytest.mark.parametrize("name", ["product_rbf_matern12", "theta_override_sum"])
def test_gram_from_cache_equals_gram(name):
    tk = KERNELS[name](tgp)
    assert tbase.supports_gram_cache(tk)
    x = torch.as_tensor(_x(4, (E, S, P)))
    theta = torch.as_tensor(tk.init_theta() * 1.1)
    _close(tk.gram_from_cache(theta, tk.prepare(x)).numpy(), tk.gram(theta, x).numpy(), 1e-14)


@pytest.mark.parametrize("factor", [
    lambda m: m.WhiteNoiseKernel(0.1, 0, 1),
    lambda m: m.WhiteNoiseKernel(0.0, 0, 1),  # trainable noise that starts at 0
    lambda m: m.RBFKernel() + m.Const(1e-3) * m.EyeKernel(),
])
def test_product_refuses_white_noise_factors(factor):
    for m in (jgp, tgp):
        with pytest.raises(ValueError, match="white-noise factors"):
            m.RBFKernel() * factor(m)
    # a constant-zero noise branch is inert and passes in both
    for m in (jgp, tgp):
        m.RBFKernel() * (m.RBFKernel() + m.Const(0.0) * m.EyeKernel())


@pytest.mark.parametrize("cls", ["ARDMatern32Kernel", "ARDMatern52Kernel"])
def test_ard_matern_gradient_finite_at_coincident_rows(cls):
    x = _x(5, (2, 6, P))
    x[:, 3] = x[:, 1]  # coincident rows within each expert
    tk = getattr(tgp, cls)(P, 0.8)
    theta = torch.as_tensor(tk.init_theta()).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(tk.gram(theta, torch.as_tensor(x))), theta)
    assert torch.all(torch.isfinite(g))
    cross = tk.cross(theta.detach(), torch.as_tensor(x), torch.as_tensor(x))
    np.testing.assert_allclose(torch.diagonal(cross, dim1=-2, dim2=-1).numpy(), 1.0, atol=1e-10)


def test_theta_override_checks_its_length():
    for m, mod in ((jgp, jbase), (tgp, tbase)):
        with pytest.raises(ValueError, match="hyperparameters"):
            mod.ThetaOverrideKernel(m.RBFKernel(), [1.0, 2.0])


def test_product_dsl_and_streaming():
    """``k1 * k2`` of two kernels builds a product, which has no
    streaming form (in either package), even of two streaming factors."""
    tk = tgp.RBFKernel(1.0) * tgp.Matern12Kernel(1.0)
    assert isinstance(tk, tbase.ProductKernel)
    assert not tbase.supports_matfree(tk)
    assert not jbase.supports_matfree(jgp.RBFKernel(1.0) * jgp.Matern12Kernel(1.0))
