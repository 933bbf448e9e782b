"""Host-optimizer checkpoints move between the two packages, in both
directions (``setCheckpointDir``, ``utils/checkpoint.py``).

Both packages write and check the kernel's structural signature as
``kernel.describe(zeros(theta_dim))``, so a fit preempted in one package
resumes in the other: a file the JAX package wrote (no evaluation log)
resumes in the port from its theta with the remaining budget, and a file
the port wrote (with its log and fingerprints beside the JAX keys)
resumes in the JAX estimator.  Regression and the binary classifier,
float64 on the CPU; the resumed fit lands within 1e-3 relative of the
resuming package's own uninterrupted theta (the host checkpoints' bar,
``test_torch_checkpoint.py``)."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import numpy as np
import pytest

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu_torch.resilience import chaos
from spark_gp_tpu_torch.utils.checkpoint import kernel_fingerprint, load_checkpoint_payload


def _regression(pkg, directory=None, max_iter=25, **kw):
    gp = (pkg.GaussianProcessRegression(**kw).setKernel(lambda: 1.0 * pkg.RBFKernel(1.0))
          .setDatasetSizeForExpert(40).setActiveSetSize(50).setMaxIter(max_iter).setSeed(3))
    return gp if directory is None else gp.setCheckpointDir(str(directory))


def _classifier(pkg, directory=None, max_iter=15, **kw):
    gp = (pkg.GaussianProcessClassifier(**kw).setKernel(lambda: pkg.RBFKernel(1.0))
          .setDatasetSizeForExpert(40).setActiveSetSize(40).setMaxIter(max_iter).setSeed(3))
    return gp if directory is None else gp.setCheckpointDir(str(directory))


def _problem(family):
    rng = np.random.default_rng(5)
    if family == "regression":
        x = rng.normal(size=(240, 3))
        return _regression, x, np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=240)
    x = rng.normal(size=(160, 2))
    return _classifier, x, (x.sum(axis=1) + 0.3 * rng.normal(size=160) > 0).astype(np.float64)


def _port_preempted(build, directory, x, y):
    """The port's fit killed after its third save."""
    with chaos.preempt_after_saves(3):
        with pytest.raises(chaos.SimulatedPreemption):
            build(tgp, directory, device="cpu").fit(x, y)


@pytest.mark.parametrize("family", ["regression", "classifier"])
def test_a_jax_written_host_checkpoint_resumes_in_the_port(tmp_path, family):
    build, x, y = _problem(family)
    # the JAX package's fit cut after its third iteration's save
    build(jgp, tmp_path, max_iter=3).fit(x, y)
    payload = load_checkpoint_payload(str(tmp_path), build(tgp, device="cpu")._checkpoint_tag())
    assert "evaluations" not in payload and payload["iteration"] == 3
    full = build(tgp, device="cpu").fit(x, y)
    resumed = build(tgp, tmp_path, device="cpu").fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == 3
    np.testing.assert_allclose(resumed.raw_predictor.theta, full.raw_predictor.theta, rtol=1e-3)


@pytest.mark.parametrize("family", ["regression", "classifier"])
def test_a_port_written_host_checkpoint_resumes_in_the_jax_package(tmp_path, family):
    build, x, y = _problem(family)
    _port_preempted(build, tmp_path, x, y)
    full = build(jgp).fit(x, y)
    resumed = build(jgp, tmp_path).fit(x, y)
    assert resumed.instr.metrics["resumed_from_iteration"] == 3
    np.testing.assert_allclose(np.asarray(resumed.raw_predictor.theta),
                               np.asarray(full.raw_predictor.theta), rtol=1e-3)


def test_the_payload_carries_the_jax_keys(tmp_path):
    """The port's payload holds the JAX package's ``kernel``
    (``describe(theta)``) and ``kernel_sig`` (``describe`` at zeros), the
    replay guard's fingerprint under a key of its own."""
    x, y = _problem("regression")[1:]
    _port_preempted(_regression, tmp_path, x, y)
    payload = load_checkpoint_payload(str(tmp_path), "GaussianProcessRegression")
    kernel = _regression(jgp)._get_kernel()
    assert payload["kernel_sig"] == kernel.describe(np.zeros(2))
    assert payload["kernel"] == kernel.describe(np.asarray(payload["theta"]))
    assert payload["kernel_fingerprint"] == kernel_fingerprint(_regression(tgp)._get_kernel())


def _kernels(pkg):
    """One kernel of every family and composite, in ``pkg``."""
    return {
        "scaled_rbf_plus_noise": 1.0 * pkg.RBFKernel(0.5) + pkg.WhiteNoiseKernel(0.5, 0, 1),
        "ard_rbf": pkg.ARDRBFKernel(3),
        "matern12": pkg.Matern12Kernel(1.0),
        "matern32": pkg.Matern32Kernel(1.0),
        "matern52": pkg.Matern52Kernel(2.0),
        "ard_matern32": pkg.ARDMatern32Kernel(2),
        "ard_matern52": pkg.ARDMatern52Kernel(2),
        "rq": pkg.RationalQuadraticKernel(1.0, 2.0),
        "ard_rq": pkg.ARDRationalQuadraticKernel(2),
        "periodic": pkg.PeriodicKernel(1.0, 1.0),
        "spectral_mixture": pkg.SpectralMixtureKernel(2, 3),
        "dot": pkg.DotProductKernel(1.0),
        "poly": pkg.PolynomialKernel(3, 1.0),
        "product": pkg.RBFKernel(1.0) * pkg.PeriodicKernel(1.0, 1.0),
        "const_scale": pkg.Const(2.0) * pkg.RBFKernel(1.0),
        "zero_const_plus_rbf": pkg.Const(0.0) * pkg.RBFKernel(1.0) + pkg.RBFKernel(2.0),
        "eye": pkg.EyeKernel(),
    }


@pytest.mark.parametrize("name", sorted(_kernels(tgp)))
def test_kernel_describe_matches_the_jax_package(name):
    """``describe(theta)`` string for string, at zeros (the signature), at
    the initial theta and at a random one."""
    kj, kt = _kernels(jgp)[name], _kernels(tgp)[name]
    rng = np.random.default_rng(7)
    for theta in (np.zeros(kj.n_hypers), kj.init_theta(), rng.uniform(0.1, 2.0, kj.n_hypers)):
        assert kt.describe(theta) == kj.describe(theta)
