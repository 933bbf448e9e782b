"""The port's k-means provider and host multi-start against the JAX
package's, float64 on the CPU: Lloyd from the same centroids within
1e-10 (n = 500, k = 20); k-means++ seeds that are distinct rows and the
same for the same seed; the restart points bit for bit, in log and in
linear space; a 2-restart host fit with the same per-restart final NLLs
(1e-6) and best restart; and the Synthetics config with the k-means
provider below the reference's 0.11 RMSE bar on every objective."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import active_set as j_as
from spark_gp_tpu_torch.data import make_synthetics
from spark_gp_tpu_torch.models import active_set as t_as
from spark_gp_tpu_torch.utils.validation import nlpd, rmse


def _blobs(n=500, p=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(8, p))
    return centers[rng.integers(0, 8, size=n)] + rng.normal(size=(n, p))


def test_lloyd_matches_jax_from_the_same_centroids():
    x = _blobs()
    c0 = x[np.random.default_rng(1).choice(x.shape[0], size=20, replace=False)]
    want = np.asarray(j_as._lloyd(x, c0, 20))
    got = t_as._lloyd(torch.as_tensor(x), torch.as_tensor(c0), 20).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert not np.allclose(got, c0)  # the steps moved the centroids


def test_lloyd_keeps_an_empty_clusters_centroid():
    x = torch.as_tensor(_blobs(n=60))
    far = torch.full((1, 3), 1e3, dtype=torch.float64)  # never nearest
    c = t_as._lloyd(x, torch.cat([x[:4], far]), 5)
    torch.testing.assert_close(c[4:], far, rtol=0, atol=0)


def test_kmeanspp_seeds_are_distinct_rows_and_repeatable():
    x = _blobs()
    picks = []
    for seed in (3, 3, 4):
        gen = torch.Generator().manual_seed(seed)
        seeds = t_as._kmeanspp_init(gen, torch.as_tensor(x), 20).numpy()
        rows = [int(np.flatnonzero((x == r).all(axis=1))[0]) for r in seeds]
        assert len(set(rows)) == 20
        picks.append(rows)
    assert picks[0] == picks[1] and picks[0] != picks[2]


def test_provider_returns_centroids_on_the_device():
    x = _blobs(n=120)
    a = tgp.KMeansActiveSetProvider()(30, x, None, None, None, 5)
    b = tgp.KMeansActiveSetProvider()(30, x, None, None, None, 5, device=torch.device("cpu"))
    assert a.shape == (30, 3) and a.dtype == np.float64 and np.all(np.isfinite(a))
    np.testing.assert_array_equal(a, b)
    assert tgp.KMeansActiveSetProvider()(500, x, None, None, None, 5).shape == (120, 3)


@pytest.mark.parametrize("space,make", [
    ("log", lambda m: 1.0 * m.RBFKernel(0.5, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0, 1)),
    ("linear", lambda m: 1.0 * m.RBFKernel(0.5, 1e-6, 10) + m.WhiteNoiseKernel(0.0, 0, 1)),
    ("linear", lambda m: m.SpectralMixtureKernel(2, 3) + m.DotProductKernel(0.0)),
])
def test_restart_theta_batch_matches_jax_bit_for_bit(space, make):
    batches = []
    for m in (jgp, tgp):
        gp = m.GaussianProcessRegression().setKernel(lambda m=m: make(m)).setSeed(11) \
            .setNumRestarts(5, scale=0.7).setHyperSpace("auto")
        kernel = gp._get_kernel()
        assert gp._use_log_space(kernel) == (space == "log")
        batches.append(gp._restart_theta_batch(kernel))
    np.testing.assert_array_equal(batches[1], batches[0])
    np.testing.assert_array_equal(batches[1][0], make(tgp).init_theta())


def _restart_gp(m, **kw):
    return (m.GaussianProcessRegression(**kw)
            .setKernel(lambda: 1.0 * m.RBFKernel(1.5, 1e-3, 10) + m.WhiteNoiseKernel(0.3, 0, 1))
            .setDatasetSizeForExpert(40).setActiveSetSize(30).setSigma2(1e-3)
            .setMaxIter(10).setSeed(2).setNumRestarts(2))


def test_two_restart_fit_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.uniform(-3, 3, size=(120, 1))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=120)
    j_model = _restart_gp(jgp).setOptimizer("host").fit(x, y)
    t_model = _restart_gp(tgp, device="cpu").fit(x, y)
    jm, tm = j_model.instr.metrics, t_model.metrics
    for r in range(2):
        np.testing.assert_allclose(tm[f"restart_{r}_nll"], jm[f"restart_{r}_nll"], rtol=1e-6)
    assert tm["best_restart"] == jm["best_restart"] and tm["num_restarts"] == 2
    assert tm["final_nll"] == tm[f"restart_{tm['best_restart']}_nll"]
    assert tm["restarts_nfev"] >= tm["lbfgs_nfev"]
    np.testing.assert_allclose(t_model.predict(x[:9]), j_model.predict(x[:9]), rtol=1e-5,
                               atol=1e-7)


def test_classifiers_refuse_restarts():
    """The classifiers take restarts (the sequential driver,
    test_torch_restarts.py) and, as the JAX package's, refuse them beside a
    checkpoint directory, before any fit work."""
    x = np.zeros((12, 2))
    for cls in (tgp.GaussianProcessClassifier, tgp.GaussianProcessMulticlassClassifier):
        assert cls(device="cpu").setNumRestarts(2)._num_restarts == 2
        assert cls(device="cpu").setNumRestarts(1)._num_restarts == 1
        gp = cls(device="cpu").setNumRestarts(2).setCheckpointDir("/nonexistent/checkpoints")
        with pytest.raises(ValueError, match="not combinable"):
            gp.fit(x, np.arange(12.0) % 2)


@pytest.fixture(scope="module")
def synthetics_split():
    x, y = make_synthetics()
    perm = np.random.default_rng(5).permutation(len(y))
    return x, y, perm[:1500], perm[1500:]


@pytest.mark.parametrize("objective", ["marginal", "loo", "elbo"])
def test_synthetics_config_clears_the_bar(synthetics_split, objective):
    """examples/synthetics.py's ``make_gp(objective)`` on the 1500 / 500
    split of quality.py's objectives part (the JAX package: 0.09616,
    0.09620, 0.09628 held-out RMSE)."""
    x, y, tr, te = synthetics_split
    if objective == "elbo":
        kernel, sigma2 = (lambda: 1.0 * tgp.RBFKernel(0.1, 1e-6, 10)), 1e-2
    else:
        kernel, sigma2 = (lambda: 1.0 * tgp.RBFKernel(0.1, 1e-6, 10)
                          + tgp.WhiteNoiseKernel(0.5, 0, 1)), 1e-3
    model = (tgp.GaussianProcessRegression(device="cpu").setKernel(kernel)
             .setDatasetSizeForExpert(100).setActiveSetProvider(tgp.KMeansActiveSetProvider())
             .setActiveSetSize(100).setSeed(13).setSigma2(sigma2).setObjective(objective)
             .fit(x[tr], y[tr]))
    mean, var = model.predict_with_var(x[te])
    assert rmse(y[te], mean) < 0.11
    assert np.isfinite(nlpd(y[te], mean, var))
