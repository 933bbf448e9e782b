"""The device magic solve (``models/ppa.magic_solve_device``, run on the
CPU) against the JAX package's ``magic_solve_device`` and
``_host_magic_solve`` on the same float64 statistics (rel 1e-10), for one
and for ``[m, C]`` right-hand sides and mean-only; a non-PD system raises
``NotPositiveDefiniteException``; ``magic_solve`` dispatches by m
(``_DEVICE_SOLVE_MIN_M`` monkeypatched low), under the ``ppa`` ladder: a
staged OOM at ``ppa.magic_solve`` takes one ``device_solve -> host_solve``
transition and gives the host answer, a ``NotPositiveDefiniteException``
stays raw, and a fit at the low threshold hands its statistics to the
solve as tensors and predicts what the host-solved fit does (1e-10); both
solves take tensor statistics to the same answer as numpy ones."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import ppa as jppa
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import ppa as tppa
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException
from spark_gp_tpu_torch.resilience import chaos

P = 3


def _kernel(m):
    return 1.0 * m.RBFKernel(0.8) + m.WhiteNoiseKernel(0.1, 0.0, 1.0) \
        + m.Const(1e-3) * m.EyeKernel()


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


@pytest.fixture(scope="module")
def stats():
    """``(theta, active, U1, u2, U2)`` at m = 40 from 240 rows: the JAX
    package's statistics; ``U2`` two right-hand sides."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(240, P))
    y = np.sin(x.sum(1)) + 0.05 * rng.normal(size=240)
    active = x[rng.choice(240, size=40, replace=False)]
    theta = _kernel(jgp).init_theta() * rng.uniform(0.8, 1.2, size=3)
    jd = j_group(x, y, 30)
    u1, u2 = (np.asarray(a) for a in jppa.kmn_stats_jit(
        _kernel(jgp), jnp.asarray(theta), jnp.asarray(active), jd.x, jd.y, jd.mask))
    return theta, active, u1, u2, np.stack([u2, -0.5 * u2 + 1.0], axis=1)


@pytest.mark.parametrize("rhs", ["single", "multi"])
@pytest.mark.parametrize("with_variance", [True, False])
def test_device_solve_matches_jax(stats, rhs, with_variance):
    theta, active, u1, u2, u2c = stats
    b = u2 if rhs == "single" else u2c
    j_dev = jppa.magic_solve_device(_kernel(jgp), theta, active, u1, b,
                                    with_variance=with_variance)
    j_host = jppa._host_magic_solve(_kernel(jgp), theta, active, u1, b, np.float64,
                                    with_variance)
    t_mv, t_mm = tppa.magic_solve_device(_kernel(tgp), theta, active, u1, b,
                                         with_variance=with_variance, device="cpu")
    assert t_mv.shape == np.shape(b)
    for ref in (j_dev, j_host):
        assert _rel(t_mv, ref[0]) <= 1e-10
        if with_variance:
            assert _rel(t_mm, ref[1]) <= 1e-10
        else:
            assert t_mm is None and ref[1] is None


@pytest.mark.parametrize("solve", ["device", "host"])
def test_solves_take_the_statistics_as_tensors(stats, solve):
    """The fit hands its statistics over where it built them: tensors in,
    the same float64 numpy out as from numpy operands."""
    theta, active, u1, u2, _ = stats
    fn = {"device": lambda *a: tppa.magic_solve_device(*a, device="cpu"),
          "host": tppa._host_magic_solve}[solve]
    from_numpy = fn(_kernel(tgp), theta, active, u1, u2)
    from_tensors = fn(_kernel(tgp), theta, active, torch.tensor(u1), torch.tensor(u2))
    for a, b in zip(from_numpy, from_tensors):
        assert isinstance(b, np.ndarray) and np.array_equal(a, b)


def test_device_solve_raises_when_not_pd(stats):
    theta, active, u1, u2, _ = stats
    with pytest.raises(NotPositiveDefiniteException):
        tppa.magic_solve_device(_kernel(tgp), theta, active, -1e6 * np.eye(40), u2,
                                device="cpu")


def test_dispatch_by_m(monkeypatch, stats):
    theta, active, u1, u2, _ = stats
    calls = []
    solve = tppa.magic_solve_device
    monkeypatch.setattr(tppa, "magic_solve_device",
                        lambda *a, **kw: calls.append(a[2].shape[0]) or solve(*a, **kw))
    host = tppa.magic_solve(_kernel(tgp), theta, active, u1, u2, device="cpu")
    assert calls == []
    monkeypatch.setattr(tppa, "_DEVICE_SOLVE_MIN_M", 40)
    dev = tppa.magic_solve(_kernel(tgp), theta, active, u1, u2, device="cpu")
    assert calls == [40]
    assert _rel(dev[0], host[0]) <= 1e-10 and _rel(dev[1], host[1]) <= 1e-10


def _host_solve_transitions() -> float:
    return telemetry.snapshot()["per_entry"].get("fallback.rung.host_solve", {}).get("ppa", 0.0)


def test_staged_oom_takes_the_host_rung(monkeypatch, stats):
    theta, active, u1, u2, _ = stats
    monkeypatch.setattr(tppa, "_DEVICE_SOLVE_MIN_M", 10)
    before = _host_solve_transitions()
    with chaos.oom_after_calls(0, op="ppa.magic_solve") as fired:
        mv, mm = tppa.magic_solve(_kernel(tgp), theta, active, u1, u2, device="cpu")
    assert fired[0] == 1 and _host_solve_transitions() - before == 1
    h_mv, h_mm = tppa._host_magic_solve(_kernel(tgp), theta, active, u1, u2)
    assert np.array_equal(mv, h_mv) and np.array_equal(mm, h_mm)
    # a numerical failure is not the ladder's to route around
    with pytest.raises(NotPositiveDefiniteException):
        tppa.magic_solve(_kernel(tgp), theta, active, -1e6 * np.eye(40), u2, device="cpu")
    assert _host_solve_transitions() - before == 1


def test_a_fit_over_the_threshold_solves_on_its_device(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, P))
    y = np.sin(x.sum(1))

    def fit():
        return (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
                .setDatasetSizeForExpert(50).setActiveSetSize(30).setMaxIter(3).setSeed(5)
                .fit(x, y))

    host = fit()
    calls = []
    solve = tppa.magic_solve_device
    monkeypatch.setattr(tppa, "magic_solve_device",
                        lambda *a, **kw: calls.append(a[3]) or solve(*a, **kw))
    monkeypatch.setattr(tppa, "_DEVICE_SOLVE_MIN_M", 30)
    model = fit()
    # the statistics reach the solve on the fit's device, never via numpy
    assert len(calls) == 1 and isinstance(calls[0], torch.Tensor)
    assert isinstance(model.raw_predictor.u1, np.ndarray)
    mean, var = model.predict_with_var(x[:20])
    h_mean, h_var = host.predict_with_var(x[:20])
    assert _rel(mean, h_mean) <= 1e-10 and _rel(var, h_var) <= 1e-10
    # update() takes the same dispatch
    model.update(x[:10], y[:10])
    assert len(calls) == 2
