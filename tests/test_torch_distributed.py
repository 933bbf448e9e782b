"""The rank-local expert stacks and the process group (the port's
``parallel/distributed.py``): three gloo ranks on the CPU, started once
for this file (``_torch_mesh_worker.MeshPool``), where uneven blocks
matter -- unequal rows a rank, an expert count the world size does not
divide.  ``distribute_global_experts`` and ``_pad_stack`` are held
bit-equal to the JAX package's, ``sample_active_from_stack`` and the
greedy draw to the same rows, the gradient at world size three to the
unsharded one (rtol 1e-9), fits to the JAX fits (theta rtol 1e-5,
predictions rtol 1e-6); ``initialize``, the distributed ladder and the
capture rule run in this process."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as w
import spark_gp_tpu as jgp
from spark_gp_tpu.models.greedy import greedy_active_set_from_stack as j_greedy_from_stack
from spark_gp_tpu.parallel import distributed as j_dist
from spark_gp_tpu.parallel.experts import ExpertData as JExpertData
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu.parallel.mesh import expert_mesh as j_expert_mesh
from spark_gp_tpu.parallel.mesh import shard_experts as j_shard
from spark_gp_tpu_torch.models.likelihood import check_capturable
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.parallel import distributed as t_dist
from spark_gp_tpu_torch.parallel.mesh import ExpertMesh, MeshCaptureError, expert_mesh, mesh_shape
from spark_gp_tpu_torch.resilience import chaos

P = 3
S = 20
#: unequal rows a rank: 8, 5 and 3 experts before the padding to 8
ROWS = [(0, 160), (160, 260), (260, 320)]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = w.MeshPool(3, tmp_path_factory.mktemp("dist"))
    yield ranks
    ranks.close()


def _data(n=320, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    y = np.cos(x @ np.array([0.8, -0.4, 0.6])) + 0.1 * rng.normal(size=n)
    return x, y, rng.normal(size=(25, P))


def _parts(x, y):
    return [x[lo:hi] for lo, hi in ROWS], [y[lo:hi] for lo, hi in ROWS]


def _jax_global_stack(x, y):
    """The JAX package's padding of every rank's local stack, stitched in
    rank order: the global stack the ranks' blocks make up."""
    locals_ = [j_group(x[lo:hi], y[lo:hi], S) for lo, hi in ROWS]
    e_max = max(d.num_experts for d in locals_)
    s_max = max(d.expert_size for d in locals_)
    padded = [j_dist._pad_stack(d, e_max, s_max) for d in locals_]
    return padded, JExpertData(*(jnp.concatenate([getattr(d, k) for d in padded])
                                 for k in ("x", "y", "mask")))


def test_fit_from_unequal_ranks_matches_jax(pool, eight_device_mesh):
    """``fit_distributed`` of the stack ``distribute_global_experts`` makes
    from each rank's own rows, against the JAX fit of the same global
    stack."""
    x, y, xt = _data()
    spec = {"family": "gpr", "p": P, "s": S, "m_active": 16, "maxiter": 5}
    ranks = pool.submit("fit", spec=spec, x=x, y=y, xt=xt, mode="rows", rows=ROWS)
    _, whole = _jax_global_stack(x, y)
    j_model = w.estimator(spec, jgp).setMesh(eight_device_mesh).fit_distributed(
        j_shard(whole, eight_device_mesh))
    port = ranks()
    for r in port[1:]:
        np.testing.assert_array_equal(r[0], port[0][0])
    theta, pred, active, _ = port[0]
    np.testing.assert_allclose(theta, j_model.raw_predictor.theta, rtol=1e-5)
    np.testing.assert_array_equal(active, j_model.raw_predictor.active)
    j_pred = np.asarray(j_model.raw_predictor.predict_mean(xt))
    np.testing.assert_allclose(pred, j_pred, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_pred)))


def test_distribute_global_experts_pads_unequal_ranks_as_jax(pool):
    x, y, _ = _data()
    xs, ys = _parts(x, y)
    ranks = pool.submit("distribute", x_parts=xs, y_parts=ys, s=S)
    padded, _ = _jax_global_stack(x, y)
    blocks = ranks()
    for (bx, by, bm), jd in zip(blocks, padded):
        np.testing.assert_array_equal(bx, np.asarray(jd.x))
        np.testing.assert_array_equal(by, np.asarray(jd.y))
        np.testing.assert_array_equal(bm, np.asarray(jd.mask))
    # and the port's own _pad_stack is the JAX one, value for value
    local = t_dist.group_for_experts(xs[2], ys[2], S)
    mine = t_dist._pad_stack(local, 8, 20)
    np.testing.assert_array_equal(mine.x.numpy(), np.asarray(padded[2].x))
    np.testing.assert_array_equal(mine.mask.numpy(), np.asarray(padded[2].mask))


def test_sample_active_from_stack_draws_the_jax_rows_on_every_rank(pool):
    x, y, _ = _data()
    xs, ys = _parts(x, y)
    ranks = pool.submit("sample", x_parts=xs, y_parts=ys, s=S, m=24, seed=5)
    _, whole = _jax_global_stack(x, y)
    want = j_dist.sample_active_from_stack(whole, 24, 5, None)
    rows = ranks()
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0])
    np.testing.assert_array_equal(rows[0], np.asarray(want, dtype=np.float64))


def test_greedy_from_the_stack_draws_the_jax_rows(pool):
    x, y, _ = _data()
    xs, ys = _parts(x, y)
    spec = {"family": "gpr", "p": 0, "s": S, "provider": "greedy", "sigma2": 1e-2}
    theta = np.asarray(w.estimator(spec)._get_kernel().init_theta())
    ranks = pool.submit("sample", x_parts=xs, y_parts=ys, s=S, m=12, seed=3, spec=spec,
                        theta=theta)
    _, whole = _jax_global_stack(x, y)
    mesh = j_expert_mesh(jax.devices()[:1])
    kernel = w.estimator(spec, jgp)._get_kernel()
    want = j_greedy_from_stack(12, j_shard(whole, mesh), kernel, theta, 3, mesh)
    rows = ranks()
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0])
    np.testing.assert_allclose(rows[0], want, rtol=1e-12)


def test_gradient_at_world_size_three_is_the_unsharded_one(pool):
    """E = 7 over three ranks: blocks of three after the padding to 9."""
    x, y, _ = _data(140)
    spec = {"family": "gpr", "p": P, "s": S}
    theta = np.asarray(w.estimator(spec)._get_kernel().init_theta()) * 1.1
    ranks = pool.submit("objective", spec=spec, x=x, y=y, theta=theta)
    v1, g1 = make_value_and_grad(w._kernel_of(spec), w._stack(x, y, S, None))(theta)
    value, grad = ranks()[0]
    np.testing.assert_allclose(value[0], v1, rtol=1e-10)
    np.testing.assert_allclose(grad, g1, rtol=1e-9)


def _labels(family, x):
    score = x @ np.array([1.0, -0.5, 0.3])
    if family in ("gpc", "ep"):
        return (score > 0).astype(np.float64)
    if family == "gpc_mc":
        return np.digitize(score, [-0.5, 0.5]).astype(np.float64)
    return np.random.default_rng(3).poisson(np.exp(0.5 * np.sin(score))).astype(np.float64)


@pytest.mark.parametrize("family", ["gpc", "gpc_mc", "poisson", "ep"])
def test_classifier_and_count_fits_match_jax(pool, eight_device_mesh, family):
    """``fit_distributed`` of the Laplace families and EP over three ranks
    (E = 8, padded to 9).  The JAX sharded objectives of the multiclass,
    generic and EP families sum a gradient shard_map already summed (the
    device count times the unsharded one on this jax; ROADMAP.md, reference
    caveats), so their fits are held to the JAX fit over a one-device
    mesh, where that sum is the identity."""
    x, _, xt = _data(240)
    y = _labels(family, x)
    spec = {"family": family, "p": P, "s": 30, "m_active": 16, "maxiter": 4}
    ranks = pool.submit("fit", spec=spec, x=x, y=y, xt=xt, mode="distributed")
    mesh = eight_device_mesh if family == "gpc" else j_expert_mesh(jax.devices()[:1])
    j_model = w.estimator(spec, jgp).setMesh(mesh).fit_distributed(
        j_shard(j_group(x, y, 30), mesh))
    port = ranks()
    for r in port[1:]:
        np.testing.assert_array_equal(r[0], port[0][0])
    theta, pred, _, _ = port[0]
    np.testing.assert_allclose(theta, j_model.raw_predictor.theta, rtol=1e-5)
    j_pred = np.asarray(j_model.raw_predictor.predict_mean(xt))
    np.testing.assert_allclose(pred, j_pred, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_pred)))


def _clear_env(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)


def test_initialize_alone_is_a_no_op(monkeypatch):
    _clear_env(monkeypatch)
    t_dist.initialize()
    assert not torch.distributed.is_initialized()
    assert t_dist.num_processes() == 1
    mesh = t_dist.global_expert_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.backend, mesh_shape(mesh)) == (
        1, 0, "none", [["experts", 1]])


@pytest.mark.parametrize("env, raises", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, True),         # no MASTER_ADDR: a cluster that cannot start
    ({"WORLD_SIZE": "4", "MASTER_ADDR": "localhost"}, True),   # no RANK
    ({"WORLD_SIZE": "1", "RANK": "0"}, False),         # one process: degrades, counted
])
def test_initialize_from_a_broken_environment(monkeypatch, env, raises):
    _clear_env(monkeypatch)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    before = telemetry.snapshot()["counters"].get("coord.degraded", 0.0)
    if raises:
        with pytest.raises(RuntimeError, match="cannot start the process group"):
            t_dist.initialize()
    else:
        with pytest.warns(RuntimeWarning, match="continuing as one process"):
            t_dist.initialize()
        assert telemetry.snapshot()["counters"]["coord.degraded"] == before + 1
    assert not torch.distributed.is_initialized()


def test_distributed_ladder_runs_the_single_host_rung_at_world_size_one():
    x, y, _ = _data(160)
    spec = {"family": "gpr", "p": P, "s": S, "maxiter": 5, "optimizer": "device"}
    data = t_dist.distribute_global_experts(x, y, S, expert_mesh(device="cpu"))
    clean = w.estimator(spec).fit_distributed(data)
    with chaos.oom_after_calls(0, op="sharded") as fired:
        degraded = w.estimator(spec).fit_distributed(data)
    assert fired[0] == 1
    (transition,) = degraded.degradations
    assert (transition["entry"], transition["from"], transition["to"]) == (
        "fit_sharded", "sharded", "single_host")
    np.testing.assert_allclose(degraded.raw_predictor.theta, clean.raw_predictor.theta,
                               rtol=1e-12)


def test_a_gloo_mesh_refuses_a_captured_step_on_the_card():
    """The capture rule by the backend's name: gloo stages its payloads
    through the host, so a device fit on a CUDA stack raises before any
    capture; NCCL's collectives, and a mesh without a group, ride it."""
    on_card = SimpleNamespace(x=SimpleNamespace(is_cuda=True))
    cpu = torch.device("cpu")
    with pytest.raises(MeshCaptureError, match="gloo"):
        check_capturable(ExpertMesh(object(), 0, 2, cpu, "gloo"), on_card)
    check_capturable(ExpertMesh(object(), 0, 2, cpu, "gloo"), on_card, capture=False)
    check_capturable(ExpertMesh(object(), 0, 2, cpu, "nccl"), on_card)
    check_capturable(ExpertMesh(None, 0, 1, cpu, "none"), on_card)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_capturable(ExpertMesh(object(), 0, 2, cpu, "gloo"),
                         SimpleNamespace(x=SimpleNamespace(is_cuda=False)))
