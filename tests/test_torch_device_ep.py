"""EP's device fits (``models/ep.EPLanes``, ``fit_gpc_ep_device`` and its
batched multi-start; ``GaussianProcessEPClassifier`` under
``setOptimizer("device")``), float64 on the CPU, where the loop's step runs
eagerly (the code the card captures), against the JAX package's
``fit_gpc_ep_device`` and ``fit_gpc_ep_device_multistart`` on the same
seeded stack.

* theta within 1e-6 relative, the sites and the latent posterior mean
  within 1e-6, the final NLL within 1e-9 relative, ``n_iter`` and
  ``n_fev`` equal; the multi-start's winner, its index and every lane's
  final NLL likewise.
* One sweep a step gives the default step's fit bit for bit (the sweeps
  continue across steps, a lane's convergence read over all its experts).
* A checkpoint directory runs the host driver; the ladder's ``segmented``
  rung runs the one-loop device fit (the JAX package wires no segmented
  EP variant), landing on the clean device fit."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import ep as j_ep
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import ep as t_ep
from spark_gp_tpu_torch.models import laplace_device
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group
from spark_gp_tpu_torch.resilience import chaos

TOL = 1e-6
MAX_ITER = 30
STARTS = [[1.0, 1.0], [2.5, 0.4], [0.6, 2.0]]


def _stack():
    """3 experts of 16 rows, binary labels."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(48, 2))
    return x, (x[:, 0] - 0.5 * x[:, 1] + 0.4 * rng.normal(size=48) > 0).astype(np.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def jax_fits():
    """The JAX package's single-start and 3-lane EP device fits."""
    x, y = _stack()
    data = j_group(x, y, 16)
    kernel = 1.0 * jgp.RBFKernel(1.0)
    lo, hi = (jnp.asarray(b) for b in kernel.bounds())
    one = j_ep.fit_gpc_ep_device(kernel, TOL, True, jnp.asarray(kernel.init_theta()), lo, hi,
                                 data.x, data.y, data.mask, MAX_ITER)
    multi = j_ep.fit_gpc_ep_device_multistart(kernel, TOL, True, jnp.asarray(STARTS), lo, hi,
                                              data.x, data.y, data.mask, MAX_ITER)
    return ([np.asarray(o) for o in one[:1]] + [np.asarray(s) for s in one[1]]
            + [np.asarray(o) for o in one[2:]]), [np.asarray(o) for o in multi]


def _port(starts=None, loop=None):
    x, y = _stack()
    data = t_group(x, y, 16, dtype=torch.float64, device="cpu")
    kernel = 1.0 * tgp.RBFKernel(1.0)
    lo, hi = (_t(b) for b in kernel.bounds())
    if starts is None:
        out = t_ep.fit_gpc_ep_device(kernel, TOL, True, _t(kernel.init_theta()), lo, hi, data,
                                     MAX_ITER, loop_metrics=loop)
        return [out[0].numpy(), out[1][0].numpy(), out[1][1].numpy()] + \
            [o.numpy() for o in out[2:]]
    out = t_ep.fit_gpc_ep_device_multistart(kernel, TOL, True, _t(starts), lo, hi, data,
                                            MAX_ITER, loop_metrics=loop)
    return [o.numpy() for o in out]


def test_ep_device_fit_matches_jax(jax_fits):
    want = jax_fits[0]
    loop: dict = {}
    got = _port(loop=loop)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)              # theta
    for i in (1, 2, 3):                                                 # tau, nu, latent mean
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-9)              # final NLL
    assert int(got[5]) == int(want[5]) > 2 and int(got[6]) == int(want[6])
    assert bool(got[7]) == bool(want[7])
    # one gradient pass an evaluation, every one after sweeps
    assert loop["gradient_passes"] == int(got[6])
    assert loop["newton_iterations"] >= loop["gradient_passes"]
    assert loop["newton_k"] == laplace_device.NEWTON_K["ep"]


def test_ep_multistart_matches_jax(jax_fits):
    want = jax_fits[1]
    got = _port(starts=STARTS)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)              # theta
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)   # latent mean
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)              # final NLL
    assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
    np.testing.assert_allclose(got[6], want[6], rtol=1e-9)              # every lane's NLL
    assert int(got[7]) == int(want[7])


def test_one_sweep_a_step_is_the_same_fit(monkeypatch):
    loop_k, loop_1 = {}, {}
    default = _port(loop=loop_k)
    monkeypatch.setitem(laplace_device.NEWTON_K, "ep", 1)
    one = _port(loop=loop_1)
    for a, b in zip(one, default):
        np.testing.assert_array_equal(a, b)
    assert loop_1["newton_iterations"] == loop_k["newton_iterations"]
    assert loop_1["eager_steps"] > loop_k["eager_steps"]


def _ep_gp(**kw):
    return (tgp.GaussianProcessEPClassifier(device="cpu", **kw)
            .setKernel(lambda: 1.0 * tgp.RBFKernel(1.0)).setDatasetSizeForExpert(16)
            .setActiveSetSize(16).setMaxIter(MAX_ITER).setTol(TOL))


def test_the_estimator_fits_on_the_device_and_checkpoints_on_the_host(tmp_path):
    x, y = _stack()
    dev = _ep_gp().setOptimizer("device").fit(x, y)
    host = _ep_gp().fit(x, y)
    m = dev.metrics
    assert m["optimizer"] == "device" and m["lbfgs_stalled"] == 0.0
    assert m["ep_sweeps"] >= m["objective_calls"] == m["lbfgs_nfev"]
    assert m["gram_cache_engaged"] == 0.0 and m["device_opt.eager_steps"] >= 1
    np.testing.assert_allclose(dev.raw_predictor.theta, host.raw_predictor.theta, rtol=1e-3)
    np.testing.assert_array_equal(dev.predict(x), host.predict(x))
    assert isinstance(dev, tgp.GaussianProcessEPClassificationModel)
    restarts = _ep_gp().setOptimizer("device").setNumRestarts(3).fit(x, y)
    assert restarts.metrics["num_restarts"] == 3 and restarts.metrics["final_nll"] == min(
        restarts.metrics[f"restart_{r}_nll"] for r in range(3))
    # a checkpoint directory: the host driver, its per-iteration checkpoint
    ck = _ep_gp().setOptimizer("device").setCheckpointDir(str(tmp_path)).fit(x, y)
    assert "optimizer" not in ck.metrics and "device_opt.replays" not in ck.metrics
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved and not any(name.endswith("_device_lbfgs.npz") for name in saved)
    np.testing.assert_array_equal(ck.raw_predictor.theta, host.raw_predictor.theta)


def test_the_segmented_rung_runs_the_one_loop_fit():
    """An OOM staged at every one-shot dispatch walks the solver rungs
    (EP's sweeps ignore the lane, so they fail there too) to ``segmented``,
    where EP runs its one-loop device fit: the clean fit's theta."""
    x, y = _stack()
    clean = _ep_gp().setOptimizer("device").fit(x, y)
    with chaos.oom_after_calls(0, op="one_dispatch") as fired:
        degraded = _ep_gp().setOptimizer("device").fit(x, y)
    assert fired[0] == 3
    assert [(d["from"], d["to"]) for d in degraded.degradations] == [
        ("native", "iterative"), ("iterative", "matfree"), ("matfree", "segmented")]
    np.testing.assert_array_equal(degraded.raw_predictor.theta, clean.raw_predictor.theta)
