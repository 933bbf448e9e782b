"""The port's PPA statistics, magic solve and predictor against the JAX
package at a fixed theta and active set (float64, rel 1e-10), and
``convert.py`` carrying a JAX-fitted model across."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import ppa as jppa
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch import convert
from spark_gp_tpu_torch.models import ppa as tppa
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

P = 3


def _kernel(m):
    return 1.0 * m.ARDRBFKernel(P, 0.7) + m.WhiteNoiseKernel(0.1, 0.0, 1.0) \
        + m.Const(1e-3) * m.EyeKernel()


def _setup(n=240, m=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    y = np.sin(x @ np.array([1.0, -0.5, 0.3])) + 0.05 * rng.normal(size=n)
    active = x[rng.choice(n, size=m, replace=False)]
    theta = _kernel(jgp).init_theta() * rng.uniform(0.7, 1.3, size=1 + P + 1)
    return x, y, active, theta


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


def _jax_stats(x, y, active, theta):
    jd = j_group(x, y, 30)
    return jppa.kmn_stats_jit(
        _kernel(jgp), jnp.asarray(theta), jnp.asarray(active), jd.x, jd.y, jd.mask
    )


def _port_stats(x, y, active, theta):
    return tppa.kmn_stats(
        _kernel(tgp), torch.as_tensor(theta), torch.as_tensor(active),
        t_group(x, y, 30),
    )


@pytest.mark.parametrize("chunk_elems", [None, 40 * 37])
def test_kmn_stats_match_jax(monkeypatch, chunk_elems):
    if chunk_elems is not None:  # force several (ragged) chunks
        monkeypatch.setattr(tppa, "_STATS_CHUNK_ELEMS", chunk_elems)
    x, y, active, theta = _setup()
    j_u1, j_u2 = _jax_stats(x, y, active, theta)
    t_u1, t_u2 = _port_stats(x, y, active, theta)
    assert t_u1.dtype == torch.float64
    assert _rel(t_u1.numpy(), j_u1) <= 1e-10
    assert _rel(t_u2.numpy(), j_u2) <= 1e-10


@pytest.mark.parametrize("with_variance", [True, False])
def test_magic_solve_matches_jax(with_variance):
    x, y, active, theta = _setup(seed=1)
    u1, u2 = (np.asarray(a) for a in _jax_stats(x, y, active, theta))
    j_mv, j_mm = jppa.magic_solve(_kernel(jgp), theta, active, u1, u2,
                                  with_variance=with_variance)
    t_mv, t_mm = tppa.magic_solve(_kernel(tgp), theta, active, u1, u2,
                                  with_variance=with_variance)
    assert _rel(t_mv, j_mv) <= 1e-10
    if with_variance:
        assert _rel(t_mm, j_mm) <= 1e-10
    else:
        assert t_mm is None and j_mm is None


def _predictors(seed=2):
    x, y, active, theta = _setup(seed=seed)
    u1, u2 = (np.asarray(a) for a in _jax_stats(x, y, active, theta))
    mv, mm = jppa.magic_solve(_kernel(jgp), theta, active, u1, u2)
    fields = dict(theta=theta, active=active, magic_vector=mv, magic_matrix=mm,
                  u1=u1, u2=u2)
    j_pred = jppa.ProjectedProcessRawPredictor(kernel=_kernel(jgp), **fields)
    t_pred = tppa.ProjectedProcessRawPredictor(kernel=_kernel(tgp), device="cpu", **fields)
    return j_pred, t_pred


@pytest.mark.parametrize("chunk_elems", [None, 40 * 7])
def test_predictor_matches_jax(monkeypatch, chunk_elems):
    j_pred, t_pred = _predictors()
    if chunk_elems is not None:  # several chunks of 7 rows
        monkeypatch.setattr(tppa.ProjectedProcessRawPredictor, "_PREDICT_CHUNK_ELEMS", chunk_elems)
    xt = np.random.default_rng(9).normal(size=(50, P))
    j_mean, j_var = j_pred(xt)
    t_mean, t_var = t_pred(xt)
    assert t_mean.dtype == torch.float64
    assert _rel(t_mean.numpy(), j_mean) <= 1e-10
    assert _rel(t_var.numpy(), j_var) <= 1e-10
    assert _rel(t_pred.predict_mean(xt).numpy(), j_pred.predict_mean(xt)) <= 1e-10


def test_predictor_checks_feature_count():
    _, t_pred = _predictors()
    with pytest.raises(ValueError, match=r"\[t, 3\]"):
        t_pred.predict_mean(np.zeros((4, P + 1)))


def test_convert_carries_a_jax_fitted_model():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, P))
    y = np.cos(x.sum(1)) + 0.05 * rng.normal(size=200)
    kernel = lambda m: 1.0 * m.ARDRBFKernel(P) + m.Const(1.0) * m.EyeKernel()  # noqa: E731
    j_model = (
        jgp.GaussianProcessRegression().setKernel(lambda: kernel(jgp))
        .setDatasetSizeForExpert(50).setActiveSetSize(30).setMaxIter(5).setSeed(2)
        .fit(x, y)
    )
    raw = j_model.raw_predictor
    fields = {name: np.asarray(getattr(raw, name)) for name in convert.FIELDS}
    # the port kernel of the same expression, noise-augmented like the fit
    t_kernel = kernel(tgp) + tgp.Const(1e-3) * tgp.EyeKernel()
    t_pred = convert.predictor_from_fields(fields, t_kernel, device="cpu")
    xt = rng.normal(size=(40, P))
    j_mean, j_var = j_model.predict_with_var(xt)
    t_mean, t_var = t_pred(xt)
    assert _rel(t_mean.numpy(), j_mean) <= 1e-10
    assert _rel(t_var.numpy(), j_var) <= 1e-10
    with pytest.raises(ValueError, match="hyperparameters"):
        convert.predictor_from_fields(fields, tgp.ARDRBFKernel(P), device="cpu")
