"""The device fits of the Laplace families (``setOptimizer("device")``;
``models/laplace_device.py``, ``models/laplace{,_mc,_generic}.fit_*_device*``,
the aux carry and Newton continuation of ``optimize/lbfgs_device.py``),
float64 on the CPU, where the loop's step runs eagerly (the code the card
captures).

* Each family's device fit (binary, multiclass, Poisson) against the JAX
  package's ``fit_*_device`` on the same seeded stack: theta within 1e-6
  relative, the final NLL within 1e-9 relative, the latent modes within
  1e-6, ``n_iter`` and ``n_fev`` equal.
* One Newton iteration a step (``laplace_device.NEWTON_K`` set to 1) gives
  the default step's fit bit for bit: the Newton continuation across
  steps.
* The R-lane multi-start's winner against R single-start fits.
* A segmented binary fit, and one preempted and resumed, land bit-equal on
  the one-shot fit; a device checkpoint the JAX package wrote resumes in
  the port.
* The estimators fit under ``setOptimizer("device")`` (binary,
  one-vs-rest, multiclass, Poisson, NB, and EP, whose device fit is
  ``test_torch_device_ep.py``'s), and a staged OOM takes the segmented
  rung."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import laplace as j_lap
from spark_gp_tpu.models import laplace_generic as j_gen
from spark_gp_tpu.models import laplace_mc as j_mc
from spark_gp_tpu.models.gpc_mc import _one_hot_masked as j_one_hot
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import laplace as t_lap
from spark_gp_tpu_torch.models import laplace_device
from spark_gp_tpu_torch.models import laplace_generic as t_gen
from spark_gp_tpu_torch.models import laplace_mc as t_mc
from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked as t_one_hot
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group
from spark_gp_tpu_torch.resilience import chaos

TOL = 1e-6
MAX_ITER = 60


def _stack(family):
    """``(x, y)`` of a family: 3 experts of 16 (binary, Poisson) or 15
    (multiclass, 3 classes) rows."""
    rng = np.random.default_rng({"gpc": 0, "gpc_mc": 1, "poisson": 2}[family])
    if family == "gpc":
        x = rng.normal(size=(48, 3))
        return x, (x[:, 0] + 0.5 * rng.normal(size=48) > 0).astype(np.float64)
    if family == "gpc_mc":
        x = rng.normal(size=(45, 2))
        return x, np.clip(np.round(x[:, 0] + 1 + 0.3 * rng.normal(size=45)), 0, 2)
    x = rng.normal(size=(60, 2))
    return x, rng.poisson(np.exp(0.5 * np.sin(x.sum(axis=1)) + 1.0)).astype(np.float64)


_SIZE = {"gpc": 16, "gpc_mc": 15, "poisson": 20}


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _port_fit(family, loop=None):
    """The port's single-start device fit of ``family``, host numpy."""
    x, y = _stack(family)
    data = t_group(x, y, _SIZE[family], dtype=torch.float64, device="cpu")
    kernel = 1.0 * tgp.RBFKernel(1.0)
    args = (_t(kernel.init_theta()),) + tuple(_t(b) for b in kernel.bounds())
    if family == "gpc":
        out = t_lap.fit_gpc_device(kernel, TOL, True, *args, data, MAX_ITER, loop_metrics=loop)
    elif family == "gpc_mc":
        y1h = t_one_hot(data.y, data.mask, 3)
        out = t_mc.fit_gpc_mc_device(kernel, TOL, True, *args, data.x, y1h, data.mask, MAX_ITER,
                                     loop_metrics=loop)
    else:
        out = t_gen.fit_generic_device(t_gen.PoissonLikelihood(), kernel, TOL, True, *args,
                                       data.x, data.y, data.mask, MAX_ITER, loop_metrics=loop)
    return [o.numpy() for o in out]


@pytest.fixture(scope="module", params=["gpc", "gpc_mc", "poisson"])
def jax_fit(request):
    """The JAX package's device fit of the family (one jitted call)."""
    family = request.param
    x, y = _stack(family)
    data = j_group(x, y, _SIZE[family])
    kernel = 1.0 * jgp.RBFKernel(1.0)
    lo, hi = kernel.bounds()
    args = (jnp.asarray(kernel.init_theta()), jnp.asarray(lo), jnp.asarray(hi))
    if family == "gpc":
        out = j_lap.fit_gpc_device(kernel, TOL, True, *args, data.x, data.y, data.mask, MAX_ITER)
    elif family == "gpc_mc":
        y1h = j_one_hot(data.y, data.mask, 3)
        out = j_mc.fit_gpc_mc_device(kernel, TOL, True, *args, data.x, y1h, data.mask, MAX_ITER)
    else:
        out = j_gen.fit_generic_device(j_gen.PoissonLikelihood(), kernel, TOL, True, *args,
                                       data.x, data.y, data.mask, MAX_ITER)
    return family, [np.asarray(o) for o in out]


def test_device_fit_matches_the_jax_package(jax_fit):
    family, want = jax_fit
    loop: dict = {}
    got = _port_fit(family, loop=loop)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)        # theta
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)  # latent modes
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)        # final NLL
    assert int(got[3]) == int(want[3]) > 2 and int(got[4]) == int(want[4])
    assert not bool(got[5]) and not bool(want[5])
    # every evaluation ended in one gradient pass (the initial one eagerly)
    assert loop["gradient_passes"] == int(got[4])
    assert loop["newton_iterations"] >= loop["gradient_passes"]


@pytest.mark.parametrize("family", ["gpc", "gpc_mc", "poisson"])
def test_one_newton_iteration_a_step_is_the_same_fit(family, monkeypatch):
    """The Newton loop continues across steps: one Newton iteration a step
    replays the default step's iterates bit for bit, in more steps."""
    loop_1, loop_k = {}, {}
    default = _port_fit(family, loop=loop_k)
    monkeypatch.setitem(laplace_device.NEWTON_K, "generic" if family == "poisson" else family, 1)
    one = _port_fit(family, loop=loop_1)
    for a, b in zip(one, default):
        np.testing.assert_array_equal(a, b)
    assert loop_1["newton_iterations"] == loop_k["newton_iterations"]
    assert loop_1["eager_steps"] > loop_k["eager_steps"]


def test_multistart_winner_is_the_best_single_start():
    x, y = _stack("gpc")
    data = t_group(x, y, 16, dtype=torch.float64, device="cpu")
    kernel = 1.0 * tgp.RBFKernel(1.0)
    lo, hi = (_t(b) for b in kernel.bounds())
    starts = _t([[1.0, 1.0], [3.0, 0.3], [0.5, 2.5]])
    theta, latent, nll, n_iter, n_fev, _, f_all, best = t_lap.fit_gpc_device_multistart(
        kernel, TOL, True, starts, lo, hi, data, MAX_ITER)
    singles = [t_lap.fit_gpc_device(kernel, TOL, True, starts[r], lo, hi, data, MAX_ITER)
               for r in range(3)]
    np.testing.assert_allclose(f_all.numpy(), [float(s[2]) for s in singles], rtol=1e-9)
    assert int(best) == int(np.argmin([float(s[2]) for s in singles]))
    win = singles[int(best)]
    np.testing.assert_allclose(theta.numpy(), win[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(latent.numpy(), win[1].numpy(), rtol=1e-6, atol=1e-6)
    assert int(n_iter) == int(win[3]) and int(n_fev) == int(win[4])


def _classifier(directory=None, interval=3, **kw):
    gp = (tgp.GaussianProcessClassifier(device="cpu", **kw)
          .setKernel(lambda: 1.0 * tgp.RBFKernel(1.0))
          .setDatasetSizeForExpert(16).setActiveSetSize(16).setMaxIter(MAX_ITER)
          .setTol(TOL).setOptimizer("device"))
    if directory is not None:
        gp.setCheckpointDir(str(directory)).setCheckpointInterval(interval)
    return gp


def test_segmented_and_resumed_classifier_fits_are_the_one_shot_fit(tmp_path):
    x, y = _stack("gpc")
    one = _classifier().fit(x, y)
    seg = _classifier(tmp_path / "seg").fit(x, y)
    assert (tmp_path / "seg" / "gpc_device_lbfgs.npz").exists()
    np.testing.assert_array_equal(seg.raw_predictor.theta, one.raw_predictor.theta)
    assert seg.metrics["lbfgs_nfev"] == one.metrics["lbfgs_nfev"]
    with chaos.preempt_after_saves(2):
        with pytest.raises(chaos.SimulatedPreemption):
            _classifier(tmp_path / "kill").fit(x, y)
    resumed = _classifier(tmp_path / "kill").fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == 6
    np.testing.assert_array_equal(resumed.raw_predictor.theta, one.raw_predictor.theta)
    np.testing.assert_array_equal(resumed.predict(x), one.predict(x))


def test_a_jax_written_classifier_checkpoint_resumes_in_the_port(tmp_path):
    from spark_gp_tpu.utils.checkpoint import DeviceOptimizerCheckpointer as JaxCheckpointer

    x, y = _stack("gpc")
    data = j_group(x, y, 16)
    # the estimator's kernel: the model kernel plus its sigma2 noise term
    kernel = (jgp.GaussianProcessClassifier().setKernel(lambda: 1.0 * jgp.RBFKernel(1.0))
              ._get_kernel())
    lo, hi = (jnp.asarray(b) for b in kernel.bounds())

    def jax_fit(directory, max_iter):
        return j_lap.fit_gpc_device_checkpointed(
            kernel, TOL, None, True, jnp.asarray(kernel.init_theta()), lo, hi, data, max_iter,
            3, JaxCheckpointer(str(directory), "gpc"))[0]

    full = jax_fit(tmp_path / "full", MAX_ITER)
    jax_fit(tmp_path / "cut", 6)
    resumed = _classifier(tmp_path / "cut").fit(x, y)
    assert resumed.metrics["resumed_from_iteration"] == 6
    np.testing.assert_allclose(resumed.raw_predictor.theta, np.asarray(full), rtol=1e-6)


def test_estimators_fit_on_the_device():
    """Every Laplace estimator takes ``setOptimizer("device")`` and lands
    on its host fit's optimum; one-vs-rest through the binary one; EP
    fits on the device too; ``"auto"`` is unchanged."""
    from spark_gp_tpu_torch.utils.validation import OneVsRest

    rng = np.random.default_rng(4)
    x = rng.normal(size=(90, 2))
    labels = np.clip(np.round(x[:, 0] + 1), 0, 2)
    counts = rng.poisson(np.exp(np.sin(x.sum(axis=1)))).astype(np.float64)
    cases = [
        (tgp.GaussianProcessClassifier, (labels > 0).astype(np.float64)),
        (tgp.GaussianProcessMulticlassClassifier, labels),
        (tgp.GaussianProcessPoissonRegression, counts),
        (tgp.GaussianProcessNegativeBinomialRegression, counts),
    ]
    for cls, y in cases:
        def gp(opt):
            return (cls(device="cpu").setDatasetSizeForExpert(30).setActiveSetSize(30)
                    .setTol(TOL).setOptimizer(opt))
        host, dev = gp("host").fit(x, y), gp("device").fit(x, y)
        assert dev.metrics["optimizer"] == "device" and dev.metrics["lbfgs_stalled"] == 0.0
        np.testing.assert_allclose(dev.metrics["final_nll"], host.metrics["final_nll"], rtol=1e-8)
        np.testing.assert_allclose(dev.raw_predictor.theta, host.raw_predictor.theta, rtol=1e-3)
        assert dev.metrics["newton_iterations"] >= dev.metrics["objective_calls"] \
            == dev.metrics["lbfgs_nfev"]
        np.testing.assert_array_equal(dev.predict(x[:20]) > 0.5, host.predict(x[:20]) > 0.5)
    ovr = OneVsRest(lambda: tgp.GaussianProcessClassifier(device="cpu")
                    .setDatasetSizeForExpert(30).setActiveSetSize(30).setOptimizer("device"))
    assert float(np.mean(ovr.fit(x, labels).predict(x) == labels)) > 0.9
    ep_host, ep_dev = (tgp.GaussianProcessEPClassifier(device="cpu").setDatasetSizeForExpert(30)
                       .setActiveSetSize(30).setTol(TOL).setOptimizer(opt).fit(x, labels > 0)
                       for opt in ("host", "device"))
    assert ep_dev.metrics["optimizer"] == "device" and ep_dev.metrics["lbfgs_stalled"] == 0.0
    np.testing.assert_allclose(ep_dev.metrics["final_nll"], ep_host.metrics["final_nll"],
                               rtol=1e-6)
    assert tgp.GaussianProcessClassifier(device="cpu")._resolved_optimizer() == "host"


def test_restarts_and_the_segmented_rung():
    """Restarts run as one batched loop; an OOM staged at the one-shot
    fit's choke point walks the solver rungs, which a device fit takes by
    the JAX package's rule (the same choke point fails there too), to the
    segmented rung, whose segments land on the clean fit's theta."""
    x, y = _stack("gpc")
    model = _classifier().setNumRestarts(3).fit(x, y)
    assert model.metrics["num_restarts"] == 3 and "restart_2_nll" in model.metrics
    assert model.metrics["final_nll"] == min(model.metrics[f"restart_{r}_nll"] for r in range(3))
    clean = _classifier().fit(x, y)
    with chaos.oom_after_calls(0, op="one_dispatch") as fired:
        degraded = _classifier().fit(x, y)
    assert fired[0] == 3
    assert [(d["from"], d["to"], d["failure_class"]) for d in degraded.degradations] == [
        ("native", "iterative", "oom"), ("iterative", "matfree", "oom"),
        ("matfree", "segmented", "oom")]
    np.testing.assert_array_equal(degraded.raw_predictor.theta, clean.raw_predictor.theta)


def test_the_memory_planner_counts_the_latent_stacks():
    """A Laplace device fit's byte model adds three ``[E, s, C]`` latent
    stacks and a ``[E * C, s, s]`` B stack with its inverse, per head; the
    host optimizer's model is unchanged."""
    from spark_gp_tpu_torch.resilience import memplan

    e, s, p, itemsize = 7, 20, 4, 4
    base = memplan.fit_dispatch_bytes(e, s, p, itemsize, "native")
    for heads in (1, 3):
        extra = memplan.fit_dispatch_bytes(e, s, p, itemsize, "native", latent_heads=heads) - base
        assert extra == (3 * e * s * heads + 2 * e * heads * s * s) * itemsize
    gp = tgp.GaussianProcessMulticlassClassifier(device="cpu").setDatasetSizeForExpert(15)
    gp._latent_heads = 3
    assert gp._device_latent_heads() == 0
    assert gp.setOptimizer("device")._device_latent_heads() == 3
