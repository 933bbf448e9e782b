"""The port's kernel algebra and expert grouping against the JAX package.

Same numpy inputs (seeded), float64 on both sides (the JAX session runs
with x64); kernel values agree to rtol 1e-12, the expert stack bit for bit.
"""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.kernels.base import masked_gram_stack as j_masked_gram_stack
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.kernels.base import masked_gram_stack as t_masked_gram_stack
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group
from spark_gp_tpu_torch.parallel.experts import num_experts_for, ungroup

P = 3

KERNELS = {
    "rbf": lambda m: m.RBFKernel(0.7, 1e-6, 10),
    "ard_rbf": lambda m: m.ARDRBFKernel(P, 0.8),
    # the airfoil and protein configs, noise-augmented as the estimators do
    "airfoil": lambda m: 1.0 * m.ARDRBFKernel(P) + m.Const(1.0) * m.EyeKernel()
    + m.Const(1e-4) * m.EyeKernel(),
    "protein": lambda m: 1.0 * m.ARDRBFKernel(P, P ** -0.5)
    + m.WhiteNoiseKernel(0.1, 0.0, 1.0) + m.Const(1e-3) * m.EyeKernel(),
}


def _pair(name):
    return KERNELS[name](jgp), KERNELS[name](tgp)


def _theta(kernel, seed=0):
    rng = np.random.default_rng(seed)
    return kernel.init_theta() * rng.uniform(0.6, 1.4, size=kernel.n_hypers)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_values_match_jax(name):
    jk, tk = _pair(name)
    assert tk.n_hypers == jk.n_hypers
    np.testing.assert_array_equal(tk.init_theta(), jk.init_theta())
    for t_b, j_b in zip(tk.bounds(), jk.bounds()):
        np.testing.assert_array_equal(t_b, j_b)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(23, P))
    xt = rng.normal(size=(9, P))
    theta = _theta(jk)
    jt, tt = jnp.asarray(theta), _t(theta)
    pairs = [
        (jk.gram(jt, jnp.asarray(x)), tk.gram(tt, _t(x))),
        (jk.cross(jt, jnp.asarray(xt), jnp.asarray(x)), tk.cross(tt, _t(xt), _t(x))),
        (jk.diag(jt, jnp.asarray(x)), tk.diag(tt, _t(x))),
        (jk.self_diag(jt, jnp.asarray(xt)), tk.self_diag(tt, _t(xt))),
        (jk.white_noise_var(jt), tk.white_noise_var(tt)),
    ]
    for j_val, t_val in pairs:
        assert t_val.dtype == torch.float64
        np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_masked_gram_stack_matches_jax(name):
    jk, tk = _pair(name)
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(131, P)), rng.normal(size=131)
    jd, td = j_group(x, y, 20), t_group(x, y, 20)
    theta = _theta(jk, seed=3)
    j_k = j_masked_gram_stack(jk, jnp.asarray(theta), jd.x, jd.mask)
    t_k = t_masked_gram_stack(tk, _t(theta), td.x, td.mask)
    assert tuple(t_k.shape) == j_k.shape
    np.testing.assert_allclose(t_k.numpy(), np.asarray(j_k), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n,s", [(131, 20), (100, 100), (7, 3), (1000, 37)])
def test_group_for_experts_bit_identical(n, s):
    rng = np.random.default_rng(n)
    x, y = rng.normal(size=(n, P)), rng.normal(size=n)
    jd, td = j_group(x, y, s), t_group(x, y, s)
    for j_a, t_a in ((jd.x, td.x), (jd.y, td.y), (jd.mask, td.mask)):
        assert t_a.dtype == torch.float64
        np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))
    assert td.num_experts == num_experts_for(n, s) == jd.num_experts
    np.testing.assert_array_equal(ungroup(td.y.numpy(), n), y)


def test_group_for_experts_dtype_and_device():
    x, y = np.ones((10, 2)), np.arange(10.0)
    td = t_group(x, y, 5, dtype=torch.float32, device="cpu")
    assert td.x.dtype == td.y.dtype == td.mask.dtype == torch.float32
    assert td.x.shape == (2, 5, 2)


def test_scalar_dsl_bounds_match_jax():
    exprs = [
        lambda m: m.Scalar(2.0).between(0.5).and_(30) * m.RBFKernel(),
        lambda m: m.Scalar(1.5).below(10) * m.ARDRBFKernel(2),
        lambda m: m.Scalar(3.0).const * m.RBFKernel(0.2, 0.1, 5.0),
    ]
    for expr in exprs:
        jk, tk = expr(jgp), expr(tgp)
        np.testing.assert_array_equal(tk.init_theta(), jk.init_theta())
        for t_b, j_b in zip(tk.bounds(), jk.bounds()):
            np.testing.assert_array_equal(t_b, j_b)
    with pytest.raises(ValueError):
        tgp.Scalar(-1.0) * tgp.RBFKernel()
    product = tgp.RBFKernel(0.5) * tgp.RBFKernel(2.0)
    np.testing.assert_array_equal(product.init_theta(), [0.5, 2.0])


def test_self_distance_diagonal_has_finite_gradient():
    """The pinned-zero diagonal is a selection, so the gradient through the
    gram stays finite (a sqrt there would give NaN)."""
    x = _t(np.random.default_rng(4).normal(size=(6, P)))
    theta = _t([0.9, 1.1, 0.7]).requires_grad_(True)
    tgp.ARDRBFKernel(P).gram(theta, x).sum().backward()
    assert torch.isfinite(theta.grad).all()
