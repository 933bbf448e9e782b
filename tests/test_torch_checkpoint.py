"""Host optimizer checkpoints of the port (``utils/checkpoint.py``,
``setCheckpointDir``): a fit preempted after k saves resumes and lands
within 1e-3 relative of the uninterrupted fit's theta (the JAX bar), in
no more iterations -- exactly on it, since the resume replays the logged
evaluations -- and a payload without the log resumes from its theta with
the remaining budget; a log written for other data or another kernel
spec is not replayed; damaged and foreign checkpoints are refused with
the named errors."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import json

import numpy as np
import pytest

import spark_gp_tpu_torch as tgp
from spark_gp_tpu_torch.resilience import chaos
from spark_gp_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    CheckpointMismatchError,
    LbfgsCheckpointer,
    data_fingerprint,
    kernel_fingerprint,
    kernel_signature,
    load_checkpoint,
    load_checkpoint_payload,
)

TAG = "GaussianProcessRegression"


def _problem(n=240, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=n)
    return x, y


def _gp(directory=None, max_iter=25):
    gp = (
        tgp.GaussianProcessRegression(device="cpu")
        .setKernel(lambda: 1.0 * tgp.RBFKernel(1.0))
        .setDatasetSizeForExpert(40)
        .setActiveSetSize(50)
        .setMaxIter(max_iter)
        .setSeed(3)
    )
    if directory is not None:
        gp.setCheckpointDir(str(directory))
    return gp


@pytest.mark.parametrize("kill_after", [1, 3])
def test_preempted_fit_resumes_to_the_uninterrupted_theta(tmp_path, kill_after):
    x, y = _problem(seed=1)
    full = _gp().fit(x, y)
    with chaos.preempt_after_saves(kill_after) as made:
        with pytest.raises(chaos.SimulatedPreemption) as info:
            _gp(tmp_path).fit(x, y)
    assert made[0].saves == kill_after and info.value.nfev >= kill_after
    it, theta_saved, sig = load_checkpoint(str(tmp_path), tag=TAG)
    assert it == kill_after and theta_saved.shape == full.raw_predictor.theta.shape

    resumed = _gp(tmp_path).fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == kill_after
    np.testing.assert_allclose(resumed.raw_predictor.theta, full.raw_predictor.theta, rtol=1e-3)
    assert resumed.metrics["lbfgs_iters"] <= full.metrics["lbfgs_iters"]
    # the replay retraces the uninterrupted fit: the same theta, and the
    # two legs' live evaluations add up to its evaluations
    np.testing.assert_array_equal(resumed.raw_predictor.theta, full.raw_predictor.theta)
    assert info.value.nfev + resumed.metrics["lbfgs_nfev"] == full.metrics["lbfgs_nfev"]
    assert kill_after + resumed.metrics["lbfgs_iters"] == full.metrics["lbfgs_iters"]
    # the saver kept counting from the preempted run's iteration
    assert load_checkpoint(str(tmp_path), tag=TAG)[0] == full.metrics["lbfgs_iters"]


def test_payload_without_the_log_resumes_from_its_theta(tmp_path):
    """The JAX package's payload (no evaluation log): the fit restarts
    from the saved theta with the remaining iteration budget."""
    from spark_gp_tpu_torch.utils.checkpoint import _payload_checksum

    x, y = _problem(seed=1)
    full = _gp().fit(x, y)
    with chaos.preempt_after_saves(3):
        with pytest.raises(chaos.SimulatedPreemption):
            _gp(tmp_path).fit(x, y)
    path = tmp_path / f"lbfgs_state_{TAG}.json"
    payload = json.loads(path.read_text())
    del payload["evaluations"]
    payload["checksum"] = _payload_checksum(payload)
    path.write_text(json.dumps(payload))
    resumed = _gp(tmp_path).fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == 3
    np.testing.assert_allclose(resumed.raw_predictor.theta, full.raw_predictor.theta, rtol=1e-3)
    assert resumed.metrics["lbfgs_iters"] <= full.metrics["lbfgs_iters"]


def test_host_resume_consumes_the_checkpoint(tmp_path):
    """The JAX package's host-resume case: a finished fit's checkpoint
    makes a refit converge at once to the same theta."""
    x, y = _problem(seed=4)
    gp = _gp(tmp_path, max_iter=20)
    model = gp.fit(x, y)
    ck = load_checkpoint(str(tmp_path), tag=TAG)
    assert ck is not None and ck[0] >= 1 and ck[1].shape == model.raw_predictor.theta.shape
    model2 = gp.fit(x, y)
    assert model2.metrics["lbfgs_iters"] <= model.metrics["lbfgs_iters"]
    np.testing.assert_allclose(model2.raw_predictor.theta, model.raw_predictor.theta, rtol=1e-3)


@pytest.mark.parametrize("change", ["data", "kernel_spec"])
def test_a_finished_fit_does_not_answer_for_another_fit(tmp_path, change):
    """A converged fit's checkpoint in the directory, then a fit of other
    data (or of a kernel of the same structure with another initial
    value): the log is not replayed, and the second fit computes its own
    optimum, bit-equal to a fit without a checkpoint directory."""
    x, y = _problem(seed=1)
    first = _gp(tmp_path).fit(x, y)
    assert first.metrics["lbfgs_iters"] < 25  # converged inside the budget
    second = lambda d=None: _gp(d)  # noqa: E731
    if change == "data":
        x, y = _problem(seed=7)
    else:
        second = lambda d=None: _gp(d).setKernel(lambda: 1.0 * tgp.RBFKernel(0.5))  # noqa: E731
    fresh = second().fit(x, y)
    again = second(tmp_path).fit(x, y)
    assert "resumed_from_iteration" not in again.metrics
    assert again.metrics["lbfgs_nfev"] == fresh.metrics["lbfgs_nfev"] > 0
    np.testing.assert_allclose(again.raw_predictor.theta, fresh.raw_predictor.theta, rtol=1e-3)
    np.testing.assert_array_equal(again.raw_predictor.theta, fresh.raw_predictor.theta)
    if change == "data":  # another optimum: the old log's answer would be stale
        assert np.max(np.abs(again.raw_predictor.theta - first.raw_predictor.theta)) > 1e-3
    # the directory now holds the second fit's checkpoint, which resumes it
    payload = load_checkpoint_payload(str(tmp_path), tag=TAG)
    assert payload["iteration"] == again.metrics["lbfgs_iters"]
    third = second(tmp_path).fit(x, y)
    assert third.metrics["resumed_from_iteration"] == payload["iteration"]
    assert third.metrics["lbfgs_nfev"] == 0
    np.testing.assert_array_equal(third.raw_predictor.theta, fresh.raw_predictor.theta)


def test_checkpoint_at_the_budget_returns_its_iterate(tmp_path):
    x, y = _problem(seed=2)
    with chaos.preempt_after_saves(2):
        with pytest.raises(chaos.SimulatedPreemption):
            _gp(tmp_path, max_iter=2).fit(x, y)
    saved = load_checkpoint(str(tmp_path), tag=TAG)[1]
    model = _gp(tmp_path, max_iter=2).fit(x, y)
    assert model.metrics["lbfgs_iters"] == 0 and model.metrics["lbfgs_nfev"] == 1
    np.testing.assert_array_equal(model.raw_predictor.theta, saved)


def test_flipped_byte_raises_corrupt(tmp_path):
    x, y = _problem(seed=3)
    _gp(tmp_path, max_iter=3).fit(x, y)
    path = tmp_path / f"lbfgs_state_{TAG}.json"
    payload = json.loads(path.read_text())
    payload["theta"][0] += 1e-9  # a silent bit of damage, checksum kept
    path.write_text(json.dumps(payload))
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        _gp(tmp_path).fit(x, y)
    path.write_text("{not json")
    with pytest.raises(CheckpointCorruptError, match="not valid JSON"):
        load_checkpoint_payload(str(tmp_path), tag=TAG)


def test_checkpoint_of_another_kernel_raises_mismatch(tmp_path):
    x, y = _problem(seed=5)
    _gp(tmp_path, max_iter=3).fit(x, y)  # 1.0 * RBF: two hypers
    other = _gp(tmp_path).setKernel(lambda: 1.0 * tgp.Matern52Kernel(1.0))  # two hypers
    with pytest.raises(CheckpointMismatchError, match="different kernel configuration"):
        other.fit(x, y)


def test_objectives_and_elbo_surfaces_get_their_own_files(tmp_path):
    x, y = _problem(n=160, seed=6)
    _gp(tmp_path, max_iter=2).fit(x, y)
    _gp(tmp_path, max_iter=2).setObjective("loo").fit(x, y)
    elbo = _gp(tmp_path, max_iter=2).setObjective("elbo").setSigma2(1e-2)
    elbo.fit(x, y)
    names = sorted(p.name for p in tmp_path.glob("lbfgs_state_*.json"))
    assert names[0] == f"lbfgs_state_{TAG}-elbo-{elbo._objective_salt}.json"
    assert names[1:] == [f"lbfgs_state_{TAG}-loo.json", f"lbfgs_state_{TAG}.json"]
    # another sigma2 is another ELBO surface
    other = _gp(tmp_path, max_iter=2).setObjective("elbo").setSigma2(2e-2)
    other.fit(x, y)
    assert other._objective_salt != elbo._objective_salt


def test_classifier_resumes(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(160, 2))
    y = (x.sum(axis=1) > 0).astype(np.float64)

    def gp(d):
        return (tgp.GaussianProcessClassifier(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
                .setDatasetSizeForExpert(40).setActiveSetSize(40).setMaxIter(15)
                .setCheckpointDir(str(d)))

    theta_full = gp(tmp_path / "a").fit(x, y).raw_predictor.theta
    with chaos.preempt_after_saves(2):
        with pytest.raises(chaos.SimulatedPreemption):
            gp(tmp_path / "b").fit(x, y)
    resumed = gp(tmp_path / "b").fit(x, y)
    np.testing.assert_allclose(resumed.raw_predictor.theta, theta_full, rtol=1e-3)
    assert float(np.mean(resumed.predict(x) == y)) > 0.9


def test_setters_validate_like_the_jax_package(tmp_path):
    gp = _gp()
    with pytest.warns(UserWarning, match="no effect.*item 4"):
        assert gp.setCheckpointInterval(4) is gp
    with pytest.raises(ValueError, match=">= 1"):
        gp.setCheckpointInterval(0)
    with pytest.raises(ValueError, match="not combinable"):
        _gp(tmp_path).setNumRestarts(2).fit(*_problem(n=80))


def test_checkpointer_payload_and_fingerprints(tmp_path):
    kernel = 1.0 * tgp.RBFKernel(0.1, 1e-6, 10.0)
    ck = LbfgsCheckpointer(str(tmp_path), kernel, tag="t", seed=7)
    for i in range(10):
        ck(np.array([1.0, 0.1 * (i + 1)]))
    payload = load_checkpoint_payload(str(tmp_path), tag="t")
    assert payload["iteration"] == 10 and payload["seed"] == 7
    assert payload["kernel"] == kernel_fingerprint(kernel) and payload["data_fingerprint"] is None
    assert payload["kernel_sig"] == kernel_signature(kernel, 2)
    assert kernel_signature(kernel, 2) != kernel_signature(1.0 * tgp.Matern52Kernel(0.1), 2)
    a = kernel_fingerprint(1.0 * tgp.RBFKernel(0.1, 1e-6, 10.0))
    b = kernel_fingerprint(1.0 * tgp.RBFKernel(0.1, 1e-6, 20.0))  # bounds differ
    c = kernel_fingerprint(1.0 * tgp.RBFKernel(0.1, 1e-6, 10.0) + tgp.WhiteNoiseKernel(0.5, 0, 1))
    assert len({a, b, c}) == 3
    assert a == kernel_fingerprint(1.0 * tgp.RBFKernel(0.1, 1e-6, 10.0))
    x = np.arange(6.0).reshape(2, 3)
    assert data_fingerprint(x) == data_fingerprint(x.copy()) == [15.0, 55.0]
    assert data_fingerprint(x) != data_fingerprint(x[::-1] * 2)
