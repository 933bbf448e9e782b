"""The port's Matern, rational-quadratic, dot-product and polynomial
kernels against the JAX package's (float64): ``gram`` / ``cross`` /
``diag`` / ``self_diag`` within 1e-12, the same theta layout and bounds,
the streamed product equal to the materialized one, and the same answer
to ``supports_matfree`` for composites, ARD and products."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.kernels.base import supports_matfree as j_supports
from spark_gp_tpu_torch.kernels.base import supports_matfree as t_supports

FAMILIES = {
    "matern12": lambda m: m.Matern12Kernel(0.8, 1e-6, 10.0),
    "matern32": lambda m: m.Matern32Kernel(0.8, 1e-6, 10.0),
    "matern52": lambda m: m.Matern52Kernel(1.3),
    "rq": lambda m: m.RationalQuadraticKernel(0.9, 1.3, lower=[1e-3, 1e-2], upper=5.0),
    "dot": lambda m: m.DotProductKernel(0.5),
    "poly": lambda m: m.PolynomialKernel(3, 0.7),
    "scaled_sum": lambda m: 2.0 * m.Matern32Kernel(0.8) + m.WhiteNoiseKernel(0.1, 0, 1)
    + m.Const(1e-3) * m.EyeKernel(),
}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.max(np.abs(want)), 1.0))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gram_cross_diag_match_jax(name):
    jk, tk = FAMILIES[name](jgp), FAMILIES[name](tgp)
    np.testing.assert_array_equal(tk.init_theta(), jk.init_theta())
    for t_b, j_b in zip(tk.bounds(), jk.bounds()):
        np.testing.assert_array_equal(t_b, np.asarray(j_b))
    theta = jk.init_theta() * 1.1
    x, xt = _x(0, (2, 17, 3)), _x(1, (2, 5, 3))
    tt = torch.as_tensor(theta)
    for e in range(2):
        _close(tk.gram(tt, torch.as_tensor(x))[e].numpy(), jk.gram(jnp.asarray(theta), jnp.asarray(x[e])))
        _close(tk.cross(tt, torch.as_tensor(xt), torch.as_tensor(x))[e].numpy(),
               jk.cross(jnp.asarray(theta), jnp.asarray(xt[e]), jnp.asarray(x[e])))
        _close(tk.diag(tt, torch.as_tensor(x))[e].numpy(), jk.diag(jnp.asarray(theta), jnp.asarray(x[e])))
        _close(tk.self_diag(tt, torch.as_tensor(xt))[e].numpy(),
               jk.self_diag(jnp.asarray(theta), jnp.asarray(xt[e])))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_streamed_product_equals_materialized(name):
    """``matvec_from_prepared`` against ``gram @ v`` (ragged s, batched),
    and its theta-gradient against the gram's."""
    tk = FAMILIES[name](tgp)
    x, v = torch.as_tensor(_x(2, (3, 29, 4))), torch.as_tensor(_x(3, (3, 29, 2)))
    grads = []
    for streamed in (True, False):
        theta = torch.as_tensor(tk.init_theta() * 0.9).requires_grad_(True)
        out = (tk.matvec_from_prepared(theta, tk.prepare_matvec(x), v) if streamed
               else tk.gram(theta, x) @ v)
        grads.append((out.detach().numpy(), torch.autograd.grad(out.sum(), theta)[0].numpy()))
    (o_s, g_s), (o_m, g_m) = grads
    _close(o_s, o_m, 1e-12)
    _close(g_s, g_m, 1e-12)


def test_supports_matfree_matches_jax():
    cases = {
        "rbf": lambda m: m.RBFKernel(1.0),
        "ard": lambda m: m.ARDRBFKernel(3),
        "sum_with_ard": lambda m: m.RBFKernel(1.0) + m.ARDRBFKernel(3),
        "scaled_ard": lambda m: 2.0 * m.ARDRBFKernel(3),
        "const_ard": lambda m: m.Const(2.0) * m.ARDRBFKernel(3),
        "eye": lambda m: m.EyeKernel(),
        "protein_matfree": lambda m: 1.0 * m.RBFKernel(1.0, 1e-6, 10)
        + m.WhiteNoiseKernel(0.1, 0, 1) + m.Const(1e-3) * m.EyeKernel(),
        **FAMILIES,
    }
    for name, make in cases.items():
        assert t_supports(make(tgp)) == j_supports(make(jgp)), name
    # products cannot stream, in either package
    assert not j_supports(jgp.RBFKernel(1.0) * jgp.Matern12Kernel(1.0))
    assert not t_supports(tgp.RBFKernel(1.0) * tgp.Matern12Kernel(1.0))


def test_polynomial_degree_must_be_positive():
    with pytest.raises(ValueError, match="degree"):
        tgp.PolynomialKernel(0)
