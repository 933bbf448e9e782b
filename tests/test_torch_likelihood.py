"""The port's BCM objective against the JAX package's (float64, CPU).

``make_value_and_grad`` takes float64 numpy theta and returns a float and a
float64 numpy gradient on both sides; they agree to 1e-10 relative.  The
kernel branch of ``batched_nll`` (inverse + logdet, then ``alpha = K^-1 y``)
is run on the CPU through the plain inverse and held against the Cholesky
branch.
"""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models.likelihood import make_value_and_grad as j_vag
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.kernels.base import masked_gram_stack
from spark_gp_tpu_torch.models.likelihood import (
    batched_nll,
    make_value_and_grad as t_vag,
    nll_from_cholesky,
    nll_from_inverse,
)
from spark_gp_tpu_torch.ops.spd_linalg import spd_inv_logdet_plain
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

P = 4

KERNELS = {
    "rbf": lambda m: m.RBFKernel(0.9, 1e-6, 10) + m.Const(1e-3) * m.EyeKernel(),
    "airfoil": lambda m: 1.0 * m.ARDRBFKernel(P) + m.Const(1.0) * m.EyeKernel()
    + m.Const(1e-4) * m.EyeKernel(),
    "protein": lambda m: 1.0 * m.ARDRBFKernel(P, P ** -0.5)
    + m.WhiteNoiseKernel(0.1, 0.0, 1.0) + m.Const(1e-3) * m.EyeKernel(),
}


def _data(n=157, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    y = np.sin(x.sum(1)) + 0.1 * rng.normal(size=n)
    return x, y


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("scale", [1.0, 0.6])
def test_value_and_grad_match_jax(name, scale):
    x, y = _data()
    jk, tk = KERNELS[name](jgp), KERNELS[name](tgp)
    theta = jk.init_theta() * scale
    j_v, j_g = j_vag(jk, j_group(x, y, 30))(theta)
    t_v, t_g = t_vag(tk, t_group(x, y, 30))(theta)
    assert isinstance(t_v, float)
    assert t_g.dtype == np.float64 and t_g.shape == theta.shape
    assert abs(t_v - float(j_v)) <= 1e-10 * abs(float(j_v))
    assert _rel(t_g, j_g) <= 1e-10


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_inverse_branch_matches_cholesky_branch(name):
    x, y = _data(seed=1)
    tk = KERNELS[name](tgp)
    data = t_group(x, y, 30)
    ym = data.y * data.mask
    out = []
    for branch in (
        lambda k: nll_from_inverse(k, ym, spd_inv_logdet_plain),
        lambda k: nll_from_cholesky(k, ym),
    ):
        theta = torch.as_tensor(tk.init_theta() * 0.8).requires_grad_(True)
        value = branch(masked_gram_stack(tk, theta, data.x, data.mask))
        (grad,) = torch.autograd.grad(value, theta)
        out.append((value.item(), grad.numpy()))
    (v_inv, g_inv), (v_chol, g_chol) = out
    assert abs(v_inv - v_chol) <= 1e-10 * abs(v_chol)
    assert _rel(g_inv, g_chol) <= 1e-10
    theta = torch.as_tensor(tk.init_theta() * 0.8)
    assert abs(batched_nll(tk, theta, data).item() - v_chol) <= 1e-12 * abs(v_chol)


def test_non_pd_objective_is_nan_not_an_exception():
    x, y = _data(n=40)
    x[1] = x[0]  # duplicate rows: a singular noise-free gram
    tk = tgp.RBFKernel(1.0)
    value, grad = t_vag(tk, t_group(x, y, 40))(np.array([1.0]))
    assert not np.isfinite(value)
