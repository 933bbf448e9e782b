"""The regression model's joint posterior and online update in the port
(``predict_with_cov``, ``sample_posterior``, ``update``) against the JAX
package's, float64 on the CPU, on one predictor built from the same
statistics at a fixed theta and active set.  Bars: the mean, covariance,
draws and updated statistics within 1e-10 relative (1e-8 for the draws,
whose Cholesky amplifies the covariance's rounding); the covariance's
diagonal equal to ``predict_with_var``'s variance to 1e-12 relative; the
JAX package's error messages."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import gpr as jgpr
from spark_gp_tpu.models import ppa as jppa
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import gpr as tgpr
from spark_gp_tpu_torch.models import ppa as tppa
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

P = 3


def _kernel(m):
    return 1.0 * m.ARDRBFKernel(P, 0.7) + m.WhiteNoiseKernel(0.1, 0.0, 1.0) \
        + m.Const(1e-3) * m.EyeKernel()


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    return x, np.sin(x @ np.array([1.0, -0.5, 0.3])) + 0.05 * rng.normal(size=n)


@pytest.fixture(scope="module")
def models():
    """The same PPA model in both packages (A: 160 rows, m = 30), the rows
    B to fold in and test rows; the JAX package's outputs on them."""
    x, y = _data(160, 0)
    xb, yb = _data(50, 1)
    xt, _ = _data(12, 2)
    rng = np.random.default_rng(3)
    active = x[rng.choice(160, size=30, replace=False)]
    theta = _kernel(jgp).init_theta() * rng.uniform(0.7, 1.3, size=1 + P + 1)
    jd = j_group(x, y, 40)
    u1, u2 = (np.asarray(a) for a in jppa.kmn_stats_jit(
        _kernel(jgp), jnp.asarray(theta), jnp.asarray(active), jd.x, jd.y, jd.mask))
    mv, mm = jppa.magic_solve(_kernel(jgp), theta, active, u1, u2)
    fields = dict(theta=theta, active=active, magic_vector=np.asarray(mv),
                  magic_matrix=np.asarray(mm), u1=u1, u2=u2)
    j_model = jgpr.GaussianProcessRegressionModel(
        jppa.ProjectedProcessRawPredictor(kernel=_kernel(jgp), **fields))
    t_model = tgpr.GaussianProcessRegressionModel(
        tppa.ProjectedProcessRawPredictor(kernel=_kernel(tgp), device="cpu", **fields))
    j_up = j_model.update(xb, yb)
    return {
        "x": x, "y": y, "xb": xb, "yb": yb, "xt": xt, "active": active, "theta": theta,
        "j": j_model, "t": t_model,
        "j_cov": j_model.predict_with_cov(xt),
        "j_draws": j_model.sample_posterior(xt, n_samples=4, seed=11),
        "j_up": j_up, "j_up_mean": j_up.predict(xt),
    }


def test_predict_with_cov_matches_jax(models):
    mean, cov = models["t"].predict_with_cov(models["xt"])
    j_mean, j_cov = models["j_cov"]
    assert cov.shape == (12, 12) and np.array_equal(cov, cov.T)
    assert _rel(mean, j_mean) <= 1e-10
    assert _rel(cov, j_cov) <= 1e-10


def test_cov_diagonal_is_the_variance(models):
    _, cov = models["t"].predict_with_cov(models["xt"])
    _, var = models["t"].predict_with_var(models["xt"])
    assert _rel(np.diag(cov), var) <= 1e-12


def test_sample_posterior_matches_jax(models):
    draws = models["t"].sample_posterior(models["xt"], n_samples=4, seed=11)
    assert draws.shape == (4, 12)
    assert _rel(draws, models["j_draws"]) <= 1e-8


def test_update_matches_jax_and_the_union_model(models):
    d = models
    up = d["t"].update(d["xb"], d["yb"])
    raw, j_raw = up.raw_predictor, d["j_up"].raw_predictor
    assert _rel(raw.u1, j_raw.u1) <= 1e-10 and _rel(raw.u2, j_raw.u2) <= 1e-10
    assert _rel(raw.magic_vector, j_raw.magic_vector) <= 1e-10
    assert _rel(raw.magic_matrix, j_raw.magic_matrix) <= 1e-10
    assert _rel(up.predict(d["xt"]), d["j_up_mean"]) <= 1e-10
    # the PPA built on A and B together at the same theta and active set
    xu, yu = np.concatenate([d["x"], d["xb"]]), np.concatenate([d["y"], d["yb"]])
    u1, u2 = tppa.kmn_stats(_kernel(tgp), torch.as_tensor(d["theta"]),
                            torch.as_tensor(d["active"]), t_group(xu, yu, 40))
    assert _rel(raw.u1, u1.numpy()) <= 1e-10 and _rel(raw.u2, u2.numpy()) <= 1e-10
    # the original model is untouched
    assert d["t"].raw_predictor.u1 is not raw.u1
    assert _rel(d["t"].predict(d["xt"]), d["j"].predict(d["xt"])) <= 1e-10


def test_update_chunks_like_one_pass(models, monkeypatch):
    whole = models["t"].update(models["xb"], models["yb"]).raw_predictor
    monkeypatch.setattr(tppa.ProjectedProcessRawPredictor, "_PREDICT_CHUNK_ELEMS", 30 * 7)
    chunked = models["t"].update(models["xb"], models["yb"]).raw_predictor
    assert _rel(chunked.u1, whole.u1) <= 1e-12 and _rel(chunked.u2, whole.u2) <= 1e-12


def _mean_only(models):
    raw = models["t"].raw_predictor
    return tgpr.GaussianProcessRegressionModel(tppa.ProjectedProcessRawPredictor(
        kernel=raw.kernel, theta=raw.theta, active=raw.active,
        magic_vector=raw.magic_vector, magic_matrix=None, device="cpu"))


@pytest.mark.parametrize("call, message", [
    (lambda d: _mean_only(d).update(d["xb"], d["yb"]), "does not carry updatable PPA"),
    (lambda d: d["t"].update(d["xb"][:, :2], d["yb"]), r"x_new must be \[t, 3\]"),
    (lambda d: d["t"].update(d["xb"], d["yb"][:-1]), r"y_new must be \[50\]"),
    (lambda d: _mean_only(d).predict_with_cov(d["xt"]), "no covariance operator"),
])
def test_errors_are_the_jax_packages(models, call, message):
    with pytest.raises(ValueError, match=message):
        call(models)


def test_classifier_models_keep_no_update_statistics():
    x, y = _data(60, 4)
    model = tgp.GaussianProcessClassifier(device="cpu").setDatasetSizeForExpert(30) \
        .setActiveSetSize(10).setMaxIter(2).fit(x, (y > 0).astype(np.float64))
    assert model.raw_predictor.u1 is None and model.raw_predictor.u2 is None
    with pytest.raises(ValueError, match="does not carry updatable PPA"):
        model.raw_predictor.with_additional_data(x[:3], y[:3])
