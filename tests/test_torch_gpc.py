"""The binary classifier end to end: both packages fit the same data
(float64, CPU; the JAX side on its host optimizer) and agree on theta*
(rtol 1e-5) and the class probabilities (1e-6); a JAX model carried
across by ``classifier_from_fields`` predicts what it predicts (1e-10);
the Gauss-Hermite integrator, the data loaders and the evaluation
helpers against the JAX package's; one-vs-rest on iris; and the
estimator surface this slice leaves out."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import copy

import jax.numpy as jnp
import jax.nn
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.data import datasets as j_data
from spark_gp_tpu.ops.integrator import Integrator as JIntegrator
from spark_gp_tpu.utils import validation as j_val
from spark_gp_tpu_torch.convert import FIELDS, classifier_from_fields
from spark_gp_tpu_torch.data import datasets as t_data
from spark_gp_tpu_torch.ops.integrator import Integrator as TIntegrator
from spark_gp_tpu_torch.ops.scaling import scale
from spark_gp_tpu_torch.utils import validation as t_val


def _iris_gpc(m, **kw):
    """The reference's iris configuration: expert 20, active 30."""
    gp = m.GaussianProcessClassifier(**kw).setDatasetSizeForExpert(20).setActiveSetSize(30)
    return gp.setOptimizer("host") if m is jgp else gp


@pytest.fixture(scope="module")
def setosa_fits():
    x, y = t_data.load_iris()
    yb = (y == 1).astype(np.float64)
    return x, _iris_gpc(jgp).fit(x, yb), _iris_gpc(tgp, device="cpu").fit(x, yb)


def test_iris_binary_fit_matches_jax(setosa_fits):
    x, j_model, t_model = setosa_fits
    np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta,
                               rtol=1e-5)
    np.testing.assert_array_equal(t_model.raw_predictor.active, j_model.raw_predictor.active)
    for averaged in (False, True):
        np.testing.assert_allclose(t_model.predict_proba(x, averaged=averaged),
                                   j_model.predict_proba(x, averaged=averaged), atol=1e-6)
    np.testing.assert_array_equal(t_model.predict(x), j_model.predict(x))
    raw = t_model.predict_raw(x)
    np.testing.assert_allclose(raw[:, 0], -raw[:, 1])
    m = t_model.metrics
    assert (m["num_experts"], m["expert_size"], m["solver_lane"]) == (8, 19, "exact")
    # each evaluation runs its Newton loop, so iterations >= calls = nfev + 1
    assert m["objective_calls"] == m["lbfgs_nfev"] + 1
    assert m["newton_iterations"] >= m["objective_calls"]


def test_classifier_from_fields_carries_a_jax_model(setosa_fits):
    x, j_model, _ = setosa_fits
    raw = j_model.raw_predictor
    fields = {name: getattr(raw, name, None) for name in FIELDS}
    fields = {k: None if v is None else np.asarray(v) for k, v in fields.items()}
    model = classifier_from_fields(fields, tgp.RBFKernel() + tgp.Const(1e-3) * tgp.EyeKernel(),
                                   device="cpu")
    xt = np.random.default_rng(2).normal(loc=x.mean(0), scale=x.std(0), size=(40, 4))
    for averaged in (False, True):
        np.testing.assert_allclose(model.predict_proba(xt, averaged=averaged),
                                   j_model.predict_proba(xt, averaged=averaged),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(model.predict_raw(xt), j_model.predict_raw(xt), rtol=1e-10,
                               atol=1e-12)


def test_mnist_shaped_fit_matches_jax():
    """The 784-feature path at a small size: 300 rows of the MNIST
    stand-in, RBF(10), expert 100, active 50, tol 1e-3 (the example's
    kernel and tolerance)."""
    x, y = t_data.load_mnist_binary()
    x, y = scale(x[:300]), y[:300]
    xt = scale(t_data.load_mnist_binary()[0][300:360])
    models = [
        m.GaussianProcessClassifier(**kw).setDatasetSizeForExpert(100).setActiveSetSize(50)
        .setKernel(lambda m=m: m.RBFKernel(10.0)).setTol(1e-3)
        for m, kw in ((jgp, {}), (tgp, {"device": "cpu"}))
    ]
    j_model = models[0].setOptimizer("host").fit(x, y)
    t_model = models[1].fit(x, y)
    np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta,
                               rtol=1e-5)
    np.testing.assert_allclose(t_model.predict_proba(xt), j_model.predict_proba(xt), atol=1e-6)


def test_integrator_matches_jax():
    rng = np.random.default_rng(4)
    mean, var = rng.normal(size=(3, 5)), rng.uniform(0.0, 4.0, size=(3, 5))
    for n in (5, 32):
        want = np.asarray(JIntegrator(n).expected_of_function_of_normal(
            jnp.asarray(mean), jnp.asarray(var), jax.nn.sigmoid))
        got = TIntegrator(n).expected_of_function_of_normal(
            torch.as_tensor(mean), torch.as_tensor(var), torch.sigmoid)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    # E[X^2] = mu^2 + s^2, exactly for a 3-point rule
    got = TIntegrator(3).expected_of_function_of_normal(1.5, 0.25, lambda t: t * t)
    assert abs(float(got) - 2.5) < 1e-12


def test_loaders_and_helpers_match_jax():
    for loader in ("load_iris", "load_mnist_binary"):
        tx, ty = getattr(t_data, loader)()
        jx, jy = getattr(j_data, loader)()
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert t_data.MNIST_STANDIN_BAYES_ACCURACY == j_data.MNIST_STANDIN_BAYES_ACCURACY
    a, b = np.array([0, 1, 2, 2]), np.array([0, 2, 2, 2])
    assert t_val.accuracy(a, b) == j_val.accuracy(a, b) == 0.75
    assert t_val.accuracy.greater_is_better

    class Nearest:
        """A stand-in estimator: predicts the label of the first training
        row whose first feature is closest."""

        def fit(self, x, y):
            self.x, self.y = x, y
            return self

        def predict(self, x):
            return self.y[np.argmin(np.abs(x[:, :1] - self.x[None, :, 0]), axis=1)]

    x, y = t_data.load_iris()
    for seed in (0, 13):
        assert t_val.train_validation_split(Nearest(), x, y, seed=seed) == \
            j_val.train_validation_split(Nearest(), x, y, seed=seed)


def test_one_vs_rest_iris_three_folds():
    x, y = t_data.load_iris()
    scores = []
    for train, test in t_val.kfold_indices(x.shape[0], 3, seed=13):
        ovr = t_val.OneVsRest(lambda: _iris_gpc(tgp, device="cpu")).fit(x[train], y[train])
        pred = ovr.predict(x[test])
        proba = ovr.predict_proba(x[test])
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-12)
        np.testing.assert_array_equal(ovr.classes_[np.argmax(proba, axis=1)], pred)
        scores.append(t_val.accuracy(y[test], pred))
    assert np.mean(scores) > 0.9


def test_estimator_surface(tmp_path):
    x, y = t_data.load_iris()
    gp = _iris_gpc(tgp, device="cpu")
    with pytest.raises(ValueError, match="Only 0 and 1 labels"):
        copy.copy(gp).fit(x, y)
    # a non-finite row: quarantined with its expert (4 % 8), as the JAX
    # package does; with the quarantine off the fit fails at its first
    # evaluation
    bad = x.copy()
    bad[4, 2] = np.inf
    model = copy.copy(gp).setMaxIter(3).fit(bad, (y == 1).astype(np.float64))
    assert model.metrics["experts_quarantined"] == 1.0 and model.metrics["bcm_renorm"] == 8 / 7
    with pytest.raises(tgp.NotPositiveDefiniteException):
        copy.copy(gp).setExpertQuarantine(False).fit(bad, (y == 1).astype(np.float64))
    with pytest.raises(ValueError, match="shape"):
        copy.copy(gp).fit(x[:, 0], y)
    # fit_distributed (item 6a) of a one-rank stack fits the same theta as
    # fit on the same rows; a stack of other labels is refused
    from spark_gp_tpu_torch.parallel.distributed import distribute_global_experts

    y01 = (y == 1).astype(np.float64)
    stack = distribute_global_experts(x, y01, gp._dataset_size_for_expert, device="cpu")
    dist_model = copy.copy(gp).setMaxIter(3).fit_distributed(stack)
    np.testing.assert_array_equal(dist_model.raw_predictor.theta,
                                  copy.copy(gp).setMaxIter(3).fit(x, y01).raw_predictor.theta)
    with pytest.raises(ValueError, match="Only 0 and 1 labels"):
        gp.fit_distributed(distribute_global_experts(x, y, gp._dataset_size_for_expert,
                                                     device="cpu"))
    # model I/O is ported (test_torch_serialization.py): a round trip
    # predicts the same
    model.save(str(tmp_path / "m.npz"))
    loaded = tgp.GaussianProcessClassificationModel.load(str(tmp_path / "m.npz"), device="cpu")
    np.testing.assert_array_equal(loaded.predict_proba(x[:6]), model.predict_proba(x[:6]))


def test_mean_only_model_refuses_averaged_probabilities():
    x, y = t_data.load_iris()
    model = _iris_gpc(tgp, device="cpu").setPredictiveVariance(False).setMaxIter(3) \
        .fit(x, (y == 2).astype(np.float64))
    assert model.predict_proba(x[:4]).shape == (4, 2)
    with pytest.raises(ValueError, match="setPredictiveVariance"):
        model.predict_proba(x[:4], averaged=True)
