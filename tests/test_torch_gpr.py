"""The slice end to end: both packages fit the same small data (float64,
CPU) and agree on the fitted theta (rtol 1e-5) and the predictions
(rtol 1e-6); plus the estimator surface this slice leaves out."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import aggregation as j_agg
from spark_gp_tpu_torch.models import aggregation as t_agg
from spark_gp_tpu_torch.models.poe import make_poe_predictor
from spark_gp_tpu_torch.serve import GPServeServer

P = 3


def _kernel(m):
    return 1.0 * m.ARDRBFKernel(P) + m.Const(1.0) * m.EyeKernel()


def _estimator(m, **kw):
    return (
        m.GaussianProcessRegression(**kw)
        .setKernel(lambda: _kernel(m))
        .setDatasetSizeForExpert(50)
        .setActiveSetSize(50)
        .setSigma2(1e-3)
        .setMaxIter(20)
        .setSeed(7)
    )


def _data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    y = np.sin(x @ np.array([1.0, 0.5, -0.7])) + 0.1 * rng.normal(size=n)
    return x, y


def test_fit_and_predict_match_jax():
    x, y = _data()
    xt = np.random.default_rng(1).normal(size=(60, P))
    j_model = _estimator(jgp).fit(x, y)
    t_model = _estimator(tgp, device="cpu").fit(x, y)
    np.testing.assert_allclose(
        t_model.raw_predictor.theta, j_model.raw_predictor.theta, rtol=1e-5
    )
    np.testing.assert_array_equal(
        t_model.raw_predictor.active, j_model.raw_predictor.active
    )
    j_mean, j_var = j_model.predict_with_var(xt)
    t_mean, t_var = t_model.predict_with_var(xt)
    assert t_mean.dtype == np.float64
    np.testing.assert_allclose(t_mean, j_mean, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_mean)))
    np.testing.assert_allclose(t_var, j_var, rtol=1e-6)
    np.testing.assert_allclose(t_model.predict(xt), t_mean, rtol=1e-12)
    assert t_model.metrics["num_experts"] == 6
    assert t_model.metrics["lbfgs_nfev"] >= 1


def test_mean_only_model():
    x, y = _data(n=120)
    model = _estimator(tgp, device="cpu").setPredictiveVariance(False).fit(x, y)
    assert model.raw_predictor.magic_matrix is None
    assert np.all(np.isfinite(model.predict(x[:5])))
    with pytest.raises(ValueError, match="setPredictiveVariance"):
        model.predict_with_var(x[:5])


def test_set_device_and_snake_case_aliases():
    x, y = _data(n=120)
    model = (
        tgp.GaussianProcessRegression().set_device("cpu").set_kernel(lambda: _kernel(tgp))
        .set_dataset_size_for_expert(40).set_active_set_size(20).set_max_iter(3)
        .fit(x, y)
    )
    assert model.raw_predictor.device == "cpu"
    assert model.predict(x[:3]).shape == (3,)


def test_non_finite_rows_raise():
    """With the quarantine off a non-finite row fails the fit in both
    packages (its expert's NLL is not finite at the first evaluation);
    with it on, the default, both drop that row's expert."""
    x, y = _data(n=150)
    x[3, 1] = np.nan  # expert 3 % 3 = 0
    with pytest.raises(jgp.NotPositiveDefiniteException):
        _estimator(jgp).setExpertQuarantine(False).fit(x, y)
    with pytest.raises(tgp.NotPositiveDefiniteException):
        _estimator(tgp, device="cpu").setExpertQuarantine(False).fit(x, y)
    model = _estimator(tgp, device="cpu").fit(x, y)
    assert model.metrics["experts_quarantined"] == 1.0 and model.metrics["bcm_renorm"] == 1.5
    assert np.all(np.isfinite(model.predict(x[4:9])))


@pytest.mark.parametrize(
    "call",
    [
        lambda gp: gp.setOptimizer("device"),
        # restarts are ported for regression only
        lambda gp: tgp.GaussianProcessClassifier(device="cpu").setNumRestarts(3),
        lambda gp: gp.setMesh(object()),
        # (checkpoints and model I/O are ported: test_torch_checkpoint.py,
        # test_torch_serialization.py; the serve quality plane is not)
        lambda gp: GPServeServer(device="cpu", quality=True),
        lambda gp: tgp.GaussianProcessMulticlassClassifier(device="cpu").setNumRestarts(2),
        # the batched device multi-start waits for the device optimizer
        lambda gp: gp.setObjective("elbo").setNumRestarts(2).setOptimizer("device"),
        # the JAX package's remaining setters and model I/O, each naming
        # its item (setProfileDir is ported: test_torch_obs.py)
        lambda gp: GPServeServer(device="cpu").observe("m", "request", [0.0]),
        lambda gp: tgp.GaussianProcessEPClassifier(device="cpu").setNumRestarts(2),
        # (quarantine, retries and the aggregation policies are ported:
        # test_resilience_setters_match_jax)
        lambda gp: gp.setPrecisionLane("fast"),
        lambda gp: tgp.GaussianProcessClassifier(device="cpu").fit_distributed(None),
        lambda gp: gp.setPrecisionLane("mixed"),
        lambda gp: make_poe_predictor(tgp.RBFKernel(), np.ones(1), np.zeros((4, 1)),
                                      np.zeros(4), 2, mesh=object()),
    ],
)
def test_unported_options_name_their_roadmap_item(call):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item \d"):
        call(tgp.GaussianProcessRegression(device="cpu"))


@pytest.mark.parametrize("estimator", [
    "GaussianProcessRegression", "GaussianProcessClassifier", "GaussianProcessEPClassifier",
    "GaussianProcessMulticlassClassifier", "GaussianProcessPoissonRegression",
])
def test_parity_setters_take_what_the_port_does(estimator):
    gp = getattr(tgp, estimator)(device="cpu")
    assert gp.setProfileDir(None) is gp and gp.setExpertQuarantine(False) is gp
    assert gp.setFitRetries(0) is gp and gp.setPrecisionLane("strict") is gp
    try:
        assert gp.setAggregationPolicy("poe") is gp
    finally:
        t_agg.set_agg_policy(None)
    with pytest.raises(ValueError):
        gp.setCheckpointInterval(0)
    with pytest.raises(ValueError):
        gp.setFitRetries(-1)
    with pytest.raises(ValueError):
        gp.setPrecisionLane("bf16")
    with pytest.raises(ValueError):
        gp.setAggregationPolicy("mean")


@pytest.mark.parametrize("setter,values", [
    ("setExpertQuarantine", (False, True)),
    ("setFitRetries", (0, 1, 5)),
    ("setAggregationPolicy", ("poe", "gpoe", "rbcm", "healed")),
])
def test_resilience_setters_match_jax(setter, values):
    """The JAX package's defaults (quarantine on, 2 retries, the ``poe``
    policy when none is engaged), and every value its setters take."""
    j_gp, t_gp = jgp.GaussianProcessRegression(), tgp.GaussianProcessRegression(device="cpu")
    assert (t_gp._expert_quarantine, t_gp._fit_retries) == (j_gp._expert_quarantine,
                                                            j_gp._fit_retries) == (True, 2)
    try:
        for value in values:
            assert getattr(t_gp, setter)(value) is t_gp
            getattr(j_gp, setter)(value)
            assert (t_gp._expert_quarantine, t_gp._fit_retries, t_agg.active_agg_policy()) == (
                j_gp._expert_quarantine, j_gp._fit_retries, j_agg.active_agg_policy())
    finally:
        j_agg.set_agg_policy(None)
        t_agg.set_agg_policy(None)


def test_ported_options_accept_defaults():
    gp = tgp.GaussianProcessRegression(device="cpu")
    assert gp.setOptimizer("auto") is gp and gp.setOptimizer("host") is gp
    assert gp.setNumRestarts(1) is gp and gp.setMesh(None) is gp
    assert gp.setCheckpointDir(None) is gp and gp.setObjective("marginal") is gp
    assert gp.setObjective("loo") is gp and gp.setObjective("elbo") is gp
    assert gp.setNumRestarts(3) is gp and gp._num_restarts == 3
    with pytest.raises(ValueError):
        gp.setOptimizer("gpu")
    with pytest.raises(ValueError):
        gp.setHyperSpace("cubic")
