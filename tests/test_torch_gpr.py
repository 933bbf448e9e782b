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


def _device_fit_on_the_iterative_lane(est):
    """A device fit of ``est`` on the iterative solver lane, which every
    estimator takes: the fitted model."""
    from spark_gp_tpu_torch.ops.iterative import solver_lane_scope

    x = np.random.default_rng(0).normal(size=(24, 2))
    y = (x[:, 0] > 0).astype(np.float64)  # binary labels, two classes, counts
    with solver_lane_scope("iterative"):
        return est.setOptimizer("device").setDatasetSizeForExpert(12).setActiveSetSize(8) \
            .setMaxIter(3).fit(x, y)


def _device_fit_of_ep(est):
    """EP's device fit (its site pair the optimizer's carry): the model."""
    x = np.random.default_rng(0).normal(size=(24, 2))
    y = (x[:, 0] > 0).astype(np.float64)
    return est.setOptimizer("device").setDatasetSizeForExpert(12).setActiveSetSize(8) \
        .setMaxIter(3).fit(x, y)


def _device_fit_at_lane(gp, lane):
    """A device fit of the regression estimator ``gp`` at the precision
    ``lane`` (``setPrecisionLane``, process-wide, reset after): the fitted
    model, which carries the lane and the guard's metrics."""
    from spark_gp_tpu_torch.ops.precision import set_precision_lane

    x = np.random.default_rng(0).normal(size=(24, 2))
    try:
        model = gp.setPrecisionLane(lane).setOptimizer("device").setDatasetSizeForExpert(12) \
            .setActiveSetSize(8).setMaxIter(3).fit(x, np.sin(x.sum(1)))
    finally:
        set_precision_lane(None)
    assert model.metrics["precision_lane"] == lane
    assert model.metrics["mixed_precision_guard.breach"] == 0.0
    return model


def _fits(call):
    """A case of the table below that, since the device fits' slice, fits."""
    call.fits = True
    return call


def _works(call):
    """A case of the table below that, since its item was ported, does
    what the JAX package does: the call returns True."""
    call.works = True
    return call


def _server_quality_plane_on():
    """The serve quality plane (item 10b) is on when asked for."""
    server = GPServeServer(device="cpu", quality=True)
    try:
        return server.quality is not None and server.snapshot()["quality"]["enabled"] is True
    finally:
        server.stop()


def _observe_refused_with_its_code_when_the_plane_is_off():
    """``observe`` on a server with the plane off raises the JAX
    package's coded error, not an unported item."""
    from spark_gp_tpu_torch.obs.quality import QualityDisabledError

    with pytest.raises(QualityDisabledError) as info:
        GPServeServer(device="cpu", quality=False).observe("m", "request", [0.0])
    return info.value.code == "observe.disabled"


def _mesh_fit_at_world_size_one(gp):
    """``setMesh`` (item 6a) over a mesh of this process alone: the
    sharded code paths, with identity collectives, fit what ``fit`` fits."""
    from spark_gp_tpu_torch.parallel.mesh import expert_mesh

    x, y = _data(n=120)
    plain = _estimator(tgp, device="cpu").setMaxIter(5).fit(x, y)
    meshed = _estimator(tgp, device="cpu").setMaxIter(5).setMesh(expert_mesh(device="cpu")) \
        .fit(x, y)
    with pytest.raises(TypeError, match="ExpertMesh"):
        gp.setMesh(object())
    return (np.array_equal(meshed.raw_predictor.theta, plain.raw_predictor.theta)
            and np.array_equal(meshed.predict(x[:9]), plain.predict(x[:9])))


def _classifier_fit_distributed_at_world_size_one():
    """The classifier's ``fit_distributed`` (item 6a) of a one-rank stack:
    the same theta as ``fit`` on the same rows (its active set is drawn
    off the stack, so its predictions differ)."""
    from spark_gp_tpu_torch.parallel.distributed import distribute_global_experts

    x, y = _data(n=120)
    labels = (y > 0).astype(np.float64)
    gp = tgp.GaussianProcessClassifier(device="cpu").setDatasetSizeForExpert(40) \
        .setActiveSetSize(20).setMaxIter(3)
    model = gp.fit_distributed(distribute_global_experts(x, labels, 40, device="cpu"))
    plain = gp.fit(x, labels)
    return (np.array_equal(model.raw_predictor.theta, plain.raw_predictor.theta)
            and bool(np.all(np.isfinite(model.predict_proba(x[:5])))))


def _sharded_poe_at_world_size_one():
    """The sharded PoE (item 6a) over a mesh of this process alone predicts
    what the unsharded one does."""
    from spark_gp_tpu_torch.parallel.mesh import expert_mesh

    x, y = _data(n=60)
    kernel = _kernel(tgp)
    args = (kernel, kernel.init_theta(), x, y, 20)
    plain = make_poe_predictor(*args, device="cpu").predict_with_var(x[:7])
    meshed = make_poe_predictor(*args, device="cpu",
                                mesh=expert_mesh(device="cpu")).predict_with_var(x[:7])
    return all(np.array_equal(a, b) for a, b in zip(plain, meshed))


def _checkpoint_dir_under_a_one_rank_mesh():
    """A checkpoint directory under a mesh (item 6c, the coordinated
    checkpointers): a one-rank mesh's fit saves, is preempted after its
    first save, and its refit resumes to the uninterrupted fit's theta."""
    import tempfile

    from spark_gp_tpu_torch.parallel.mesh import expert_mesh
    from spark_gp_tpu_torch.resilience import chaos

    x, y = _data(n=60)
    with tempfile.TemporaryDirectory() as directory:
        def gp(ckpt):
            g = tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: _kernel(tgp)) \
                .setDatasetSizeForExpert(20).setActiveSetSize(20).setMaxIter(10) \
                .setMesh(expert_mesh(device="cpu"))
            return g.setCheckpointDir(directory) if ckpt else g

        with chaos.preempt_after_saves(1):
            try:
                gp(True).fit(x, y)
            except chaos.SimulatedPreemption:
                pass
        resumed = gp(True).fit(x, y)
        plain = gp(False).fit(x, y)
    return bool(resumed.metrics.get("resumed_from_iteration", 0) == 1
                and np.allclose(resumed.raw_predictor.theta, plain.raw_predictor.theta,
                                rtol=1e-8))


@pytest.mark.parametrize(
    "call",
    [
        # the device optimizer on the iterative lane (these cases fit)
        _fits(lambda gp: _device_fit_on_the_iterative_lane(
            tgp.GaussianProcessNegativeBinomialRegression(device="cpu"))),
        _fits(lambda gp: _device_fit_on_the_iterative_lane(
            tgp.GaussianProcessClassifier(device="cpu"))),
        _works(_mesh_fit_at_world_size_one),
        # (checkpoints and model I/O are ported: test_torch_checkpoint.py,
        # test_torch_serialization.py; the serve quality plane too,
        # test_torch_quality.py)
        _works(lambda gp: _server_quality_plane_on()),
        _fits(lambda gp: _device_fit_on_the_iterative_lane(
            tgp.GaussianProcessMulticlassClassifier(device="cpu"))),
        _fits(lambda gp: _device_fit_on_the_iterative_lane(
            tgp.GaussianProcessPoissonRegression(device="cpu"))),
        # the JAX package's remaining setters and model I/O, each naming
        # its item (setProfileDir is ported: test_torch_obs.py)
        _works(lambda gp: _observe_refused_with_its_code_when_the_plane_is_off()),
        _fits(lambda gp: _device_fit_of_ep(tgp.GaussianProcessEPClassifier(device="cpu"))),
        # (quarantine, retries and the aggregation policies are ported:
        # test_resilience_setters_match_jax)
        _fits(lambda gp: _device_fit_at_lane(gp, "fast")),
        _works(lambda gp: _classifier_fit_distributed_at_world_size_one()),
        _fits(lambda gp: _device_fit_at_lane(gp, "mixed")),
        _works(lambda gp: _sharded_poe_at_world_size_one()),
        _works(lambda gp: _checkpoint_dir_under_a_one_rank_mesh()),
    ],
)
def test_unported_options_name_their_roadmap_item(call):
    if getattr(call, "fits", False):
        # a device fit that ROADMAP.md item 4b (or, at a precision lane,
        # item 14) refused before it was ported
        model = call(tgp.GaussianProcessRegression(device="cpu"))
        assert model.metrics["optimizer"] == "device"
        assert model.metrics["lbfgs_nfev"] >= 1 and np.isfinite(model.metrics["final_nll"])
        return
    if getattr(call, "works", False):
        assert call(tgp.GaussianProcessRegression(device="cpu")) is True
        return
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
