"""Segmented device fits of the port (``setOptimizer("device")`` with
``setCheckpointDir`` / ``setCheckpointInterval``,
``utils/checkpoint.run_segmented``, ``DeviceOptimizerCheckpointer``) and
the degradation ladder's ``segmented`` rung, float64 on the CPU.  The
segments run the same steps as the one-shot loop, so a segmented fit and
a fit killed after two segments and resumed land bit-equal on the
one-shot theta; a device checkpoint the JAX package wrote resumes in the
port to the JAX package's uninterrupted theta (1e-6, the GP-fit bar of
``test_torch_device_optimizer.py``); a checkpoint of another
configuration is ignored with a warning; a staged OOM at the one-shot
fit's choke point walks the solver rungs (which a device fit takes, by the
JAX package's rule; the ARD kernel cannot stream, so no matfree rung) to
the segmented rung."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import numpy as np
import pytest

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu_torch.resilience import chaos
from spark_gp_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    DeviceOptimizerCheckpointer,
)


def _problem(n=240, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    return x, np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=n)


def _gp(pkg, directory=None, interval=3, max_iter=25, **kw):
    gp = (pkg.GaussianProcessRegression(**kw)
          .setKernel(lambda: 1.0 * pkg.ARDRBFKernel(3, 1.0, 1e-3, 20.0))
          .setDatasetSizeForExpert(40).setActiveSetSize(40).setMaxIter(max_iter)
          .setOptimizer("device").setSeed(3))
    if directory is not None:
        gp.setCheckpointDir(str(directory)).setCheckpointInterval(interval)
    return gp


def _port(directory=None, **kw):
    return _gp(tgp, directory, device="cpu", **kw)


def test_segmented_and_resumed_fits_are_the_one_shot_fit(tmp_path):
    x, y = _problem()
    one = _port().fit(x, y)
    seg = _port(tmp_path / "seg").fit(x, y)
    assert (tmp_path / "seg" / "gpr_device_lbfgs.npz").exists()
    np.testing.assert_array_equal(seg.raw_predictor.theta, one.raw_predictor.theta)
    assert seg.metrics["lbfgs_iters"] == one.metrics["lbfgs_iters"] > 6
    assert seg.metrics["lbfgs_nfev"] == one.metrics["lbfgs_nfev"]

    with chaos.preempt_after_saves(2) as made:
        with pytest.raises(chaos.SimulatedPreemption) as info:
            _port(tmp_path / "kill").fit(x, y)
    assert made[0].saves == 2 and info.value.nfev > 6
    resumed = _port(tmp_path / "kill").fit(x, y)
    np.testing.assert_array_equal(resumed.raw_predictor.theta, one.raw_predictor.theta)
    assert resumed.metrics["resumed_from_iteration"] == 6
    assert resumed.metrics["lbfgs_iters"] == one.metrics["lbfgs_iters"]


def test_a_jax_written_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's segmented fit, stopped at its iteration budget
    after two segments, leaves its state file; the port's fit of the same
    configuration resumes it (no initial evaluation) and lands on the JAX
    package's uninterrupted theta."""
    import jax.numpy as jnp

    from spark_gp_tpu.models.likelihood import fit_gpr_device_checkpointed
    from spark_gp_tpu.parallel.experts import group_for_experts
    from spark_gp_tpu.utils.checkpoint import DeviceOptimizerCheckpointer as JaxCheckpointer

    x, y = _problem(seed=2)
    jax_gp = _gp(jgp)
    kernel = jax_gp._get_kernel()
    lower, upper = (jnp.asarray(b) for b in kernel.bounds())
    data = group_for_experts(x, y, 40)

    def jax_fit(directory, max_iter):
        # the JAX package's segmented device fit (the function its
        # estimator calls under setCheckpointDir), both runs one program
        return fit_gpr_device_checkpointed(
            kernel, None, jax_gp._use_log_space(kernel), jnp.asarray(kernel.init_theta()),
            lower, upper, data, max_iter, jnp.asarray(1e-6), 3,
            JaxCheckpointer(str(directory), "gpr"))[0]

    full = jax_fit(tmp_path / "full", 25)
    jax_fit(tmp_path / "cut", 6)
    resumed = _port(tmp_path / "cut").fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == 6
    np.testing.assert_allclose(resumed.raw_predictor.theta, np.asarray(full), rtol=1e-6)


def test_a_checkpoint_of_another_configuration_is_ignored(tmp_path):
    x, y = _problem(seed=3)
    _port(tmp_path).fit(x, y)
    other = _port(tmp_path).setKernel(lambda: 1.0 * tgp.RBFKernel(1.0, 1e-6, 10.0))
    with pytest.warns(UserWarning, match="ignoring device checkpoint"):
        model = other.fit(x, y)
    assert model.raw_predictor.theta.shape == (2,)  # the scale and the RBF sigma
    assert "resumed_from_iteration" not in model.metrics
    path = DeviceOptimizerCheckpointer(str(tmp_path), "gpr").path
    with np.load(path) as npz:
        arrays = {k: np.array(npz[k]) for k in npz.files}
    arrays["leaf_0"] = arrays["leaf_0"] + 1.0
    np.savez(path, **arrays)
    with pytest.raises(CheckpointCorruptError):
        other.fit(x, y)


def test_segmented_rung_under_a_staged_oom():
    """An OOM at the one-shot device fit's choke point: the solver rungs
    apply to the device optimizer (its loop runs on every lane) and fail at
    the same choke point, so the ladder walks native -> iterative ->
    segmented (the ARD kernel cannot stream: no matfree rung), whose
    segments land on the clean fit's theta."""
    x, y = _problem(seed=4)
    clean = _port().fit(x, y)
    with chaos.oom_after_calls(0, op="one_dispatch") as fired:
        model = _port().fit(x, y)
    assert fired[0] == 2
    assert [(d["from"], d["to"], d["failure_class"]) for d in model.degradations] == [
        ("native", "iterative", "oom"), ("iterative", "segmented", "oom")]
    np.testing.assert_array_equal(model.raw_predictor.theta, clean.raw_predictor.theta)


def test_segmented_rung_gates_and_the_fit_plan(tmp_path):
    """``segmented`` applies to the plain single-start device fit only; the
    solver rungs apply to a device fit off their own lane; the memory planner plans
    device fits alone, ``native`` first; a capture failure is never
    degraded, whatever its text."""
    import torch

    from spark_gp_tpu_torch.ops.iterative import solver_lane_scope as it_lane
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.resilience import fallback, memplan

    x, y = _problem()
    data = group_for_experts(x, y, 40, dtype=torch.float32, device="cpu")
    oom = fallback.OOM
    assert fallback._fit_rung_applies(_port(), "segmented", oom, {"native"}, data)
    assert fallback._fit_rung_applies(_port(), "iterative", oom, {"native"}, data)
    with it_lane("iterative"):
        assert not fallback._fit_rung_applies(_port(), "iterative", oom, {"native"}, data)
    # the ARD kernel cannot stream
    assert not fallback._fit_rung_applies(_port(), "matfree", oom, {"native"}, data)
    assert not fallback._fit_rung_applies(_port(tmp_path), "segmented", oom, {"native"}, data)
    assert not fallback._fit_rung_applies(_port().setNumRestarts(2), "segmented", oom,
                                          {"native"}, data)
    host = _port().setOptimizer("host")
    assert not fallback._fit_rung_applies(host, "segmented", oom, {"native"}, data)
    assert memplan.plan_fit_dispatch(_port(), None, data) is None  # no budget on the CPU
    with chaos.memory_limit_bytes(1e9):
        plan = memplan.plan_fit_dispatch(_port(), None, data)
        assert plan.chosen == "native" and plan.fits
        assert [c["name"] for c in plan.candidates] == ["native", "segmented"]
        assert memplan.plan_fit_dispatch(host, None, data) is None
    with chaos.memory_limit_bytes(1.0):
        assert not memplan.plan_fit_dispatch(_port(), None, data).fits
    # a step that cannot be captured is a kernel-path failure: never degraded
    from spark_gp_tpu_torch.ops.cuda_lib import GraphCaptureError

    assert fallback.classify_failure(GraphCaptureError("out of memory")) == fallback.UNKNOWN
