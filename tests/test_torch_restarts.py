"""The classifiers' and the count model's sequential restarts
(``setNumRestarts``, ``models/common._fit_with_restarts``) against the
JAX package's driver, float64 on the CPU, on tiny stacks: the same
winner and every restart's final NLL within 1e-8; restarts beside a
checkpoint directory and a count below one are refused, as in the JAX
package."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import numpy as np
import pytest

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp


def _data(kind):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(48, 2))
    s = x.sum(axis=1)
    if kind == "binary":
        return x, (s > 0).astype(np.float64)
    if kind == "multiclass":
        return x, np.digitize(s, [-0.5, 0.5]).astype(np.float64)
    return x, rng.poisson(np.exp(0.5 * np.sin(s))).astype(np.float64)


def _estimator(pkg, kind, **kw):
    cls = {"binary": pkg.GaussianProcessClassifier,
           "multiclass": pkg.GaussianProcessMulticlassClassifier,
           "poisson": pkg.GaussianProcessPoissonRegression}[kind]
    return (cls(**kw).setKernel(lambda: 1.0 * pkg.RBFKernel(1.0, 1e-2, 10.0))
            .setDatasetSizeForExpert(24).setActiveSetSize(12).setMaxIter(4).setSeed(5)
            .setNumRestarts(3))


@pytest.mark.parametrize("kind", ["binary", "multiclass", "poisson"])
def test_restarts_match_the_jax_driver(kind):
    x, y = _data(kind)
    jm = _estimator(jgp, kind).fit(x, y).instr.metrics
    model = _estimator(tgp, kind, device="cpu").fit(x, y)
    tm = model.metrics
    assert tm["num_restarts"] == 3 and tm["best_restart"] == int(jm["best_restart"])
    for r in range(3):
        np.testing.assert_allclose(tm[f"restart_{r}_nll"], float(jm[f"restart_{r}_nll"]),
                                   rtol=1e-8)
    assert tm["final_nll"] == tm[f"restart_{tm['best_restart']}_nll"]
    assert np.all(np.isfinite(model.predict(x[:5])))


def test_restarts_are_refused_beside_checkpoints_and_below_one(tmp_path):
    gp = tgp.GaussianProcessClassifier(device="cpu").setNumRestarts(2) \
        .setCheckpointDir(str(tmp_path))
    with pytest.raises(ValueError, match="not combinable"):
        gp.fit(np.zeros((10, 2)), np.arange(10.0) % 2)
    with pytest.raises(ValueError, match=">= 1"):
        tgp.GaussianProcessPoissonRegression(device="cpu").setNumRestarts(0)
