"""The sharded fit over a process group (the port's ``parallel/mesh.py``):
two gloo ranks on the CPU, started once for this file
(``_torch_mesh_worker.MeshPool``), each on its own block of the expert
stack, against the JAX package's sharded functions on the 8-device CPU
mesh (``tests/conftest.py``), in float64.  Tolerances: the marginal and
LOO value and gradient rtol 1e-10 / 1e-9; ``(U1, u2)`` 1e-12; the Laplace,
multiclass, generic and EP objectives 1e-9; the ELBO 1e-10; fits theta
rtol 1e-5 and predictions rtol 1e-6 (``test_torch_gpr.py``'s); the sharded
device fits against the unsharded ones 1e-8; selection's report exactly."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as w
import spark_gp_tpu as jgp
from spark_gp_tpu.models import aggregation as j_agg
from spark_gp_tpu.models import ep as j_ep
from spark_gp_tpu.models import laplace as j_lap
from spark_gp_tpu.models import laplace_generic as j_lg
from spark_gp_tpu.models import laplace_mc as j_mc
from spark_gp_tpu.models import ppa as j_ppa
from spark_gp_tpu.models import sgpr as j_sgpr
from spark_gp_tpu.models.likelihood import make_sharded_value_and_grad as j_sharded_vag
from spark_gp_tpu.models.poe import make_poe_predictor as j_poe
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu.parallel.mesh import shard_experts as j_shard
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
from spark_gp_tpu_torch.ops.iterative import solver_lane_scope
from spark_gp_tpu_torch.parallel.mesh import ExpertMesh, expert_mesh

P = 3
N, S = 240, 30   # E = 8: one expert a JAX device, four a rank
SPEC = {"family": "gpr", "p": P, "s": S, "m_active": 20, "maxiter": 8}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = w.MeshPool(2, tmp_path_factory.mktemp("mesh"))
    yield ranks
    ranks.close()


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P))
    y = np.sin(x @ np.array([1.0, 0.5, -0.7])) + 0.1 * rng.normal(size=n)
    return x, y, rng.normal(size=(30, P))


def _theta():
    return np.asarray(w.estimator(SPEC)._get_kernel().init_theta()) * 0.9


def _same_on_every_rank(results):
    for r in results[1:]:
        for a, b in zip(results[0], r):
            np.testing.assert_array_equal(a, b)
    return results[0]


def _assert_fit_matches(port, j_model, xt):
    theta, pred, active, _ = port
    np.testing.assert_allclose(theta, j_model.raw_predictor.theta, rtol=1e-5)
    j_pred = np.asarray(j_model.raw_predictor.predict_mean(xt))
    np.testing.assert_allclose(pred, j_pred, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_pred)))


def test_mesh_fit_matches_jax(pool, eight_device_mesh):
    """``setMesh(mesh).fit(x, y)`` with the same rows on every rank."""
    x, y, xt = _data()
    ranks = pool.submit("fit", spec=SPEC, x=x, y=y, xt=xt, mode="mesh_fit")
    j_model = w.estimator(SPEC, jgp).setMesh(eight_device_mesh).fit(x, y)
    port = _same_on_every_rank(ranks())
    _assert_fit_matches(port, j_model, xt)
    np.testing.assert_array_equal(port[2], j_model.raw_predictor.active)
    assert port[3][1] == 8   # the global expert count


@pytest.mark.parametrize("objective, weighted", [("marginal", False), ("loo", False),
                                                 ("marginal", True)])
def test_sharded_objective_matches_jax(pool, eight_device_mesh, objective, weighted):
    x, y, _ = _data()
    theta = _theta()
    weights = np.linspace(0.5, 1.0, N // S) if weighted else None
    ranks = pool.submit("objective", spec=SPEC, x=x, y=y, theta=theta, objective=objective,
                        weights=weights)
    kernel = w.estimator(SPEC, jgp)._get_kernel()
    data = j_shard(j_group(x, y, S), eight_device_mesh)
    jv, jg = j_sharded_vag(kernel, data, eight_device_mesh, objective,
                           weights=None if weights is None else jnp.asarray(weights))(theta)
    value, grad = _same_on_every_rank(ranks())
    np.testing.assert_allclose(value[0], float(jv), rtol=1e-10)
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-9)


@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_sharded_objective_on_the_cg_lanes_sums_the_blocks(pool, lane):
    """Each block draws its own probes (as each JAX device does), so the
    sharded value is the sum of the blocks' objectives, not the unsharded
    one; the gradient is summed once, not times the world size."""
    x, y, _ = _data()
    theta = _theta()
    ranks = pool.submit("objective", spec=SPEC, x=x, y=y, theta=theta, lane=lane)
    parts = []
    for rank in range(2):
        block = w._stack(x, y, S, ExpertMesh(None, rank, 2, torch.device("cpu"), "none"))
        with solver_lane_scope(lane):
            parts.append(make_value_and_grad(w._kernel_of(SPEC), block)(theta))
    value, grad = _same_on_every_rank(ranks())
    np.testing.assert_allclose(value[0], parts[0][0] + parts[1][0], rtol=1e-12)
    np.testing.assert_allclose(grad, parts[0][1] + parts[1][1], rtol=1e-12)


def test_sharded_kmn_stats_match_jax(pool, eight_device_mesh):
    x, y, _ = _data()
    theta = _theta()
    active = x[::20]
    ranks = pool.submit("kmn", spec=SPEC, x=x, y=y, theta=theta, active=active)
    kernel = w.estimator(SPEC, jgp)._get_kernel()
    data = j_shard(j_group(x, y, S), eight_device_mesh)
    j1, j2 = j_ppa.make_sharded_kmn_stats(kernel, eight_device_mesh)(
        jnp.asarray(theta), jnp.asarray(active), data)
    u1, u2 = _same_on_every_rank(ranks())
    np.testing.assert_allclose(u1, np.asarray(j1), rtol=1e-12, atol=1e-12 * np.abs(j1).max())
    np.testing.assert_allclose(u2, np.asarray(j2), rtol=1e-12, atol=1e-12 * np.abs(j2).max())


def _labels(family, x):
    score = x @ np.array([1.0, -0.5, 0.3])
    if family in ("gpc", "ep"):
        return (score > 0).astype(np.float64)
    if family == "gpc_mc":
        return np.digitize(score, [-0.5, 0.5]).astype(np.float64)
    return np.random.default_rng(3).poisson(np.exp(0.5 * np.sin(score))).astype(np.float64)


#: the families whose JAX sharded objective psums a gradient that
#: shard_map's transpose already reduced (``laplace_mc.py``,
#: ``laplace_generic.py``, ``ep.py``): on this jax its gradient is the
#: device count times the unsharded one (ROADMAP.md, reference caveats);
#: the port's gradient is held to the JAX unsharded objective's, and its
#: fits to the JAX fits over a one-device mesh, where the psum is 1x
SCALED_GRAD = ("gpc_mc", "poisson", "ep")


@pytest.mark.parametrize("family", ["gpc", "gpc_mc", "poisson", "ep"])
def test_sharded_latent_objectives_match_jax(pool, eight_device_mesh, family):
    """The binary Laplace objective against the JAX sharded one; the
    families of ``SCALED_GRAD`` against the JAX objective over the whole
    stack (the same sum of the experts' values; the gradient the sharded
    one should have)."""
    x, _, _ = _data()
    y = _labels(family, x)
    # the inner loops (Newton, EP sweeps) stop per rank, so their tolerance
    # is tight enough that the stop does not depend on the split
    spec = {"family": family, "p": P, "s": S, "classes": 3, "tol": 1e-10}
    theta = np.asarray(w.estimator(spec)._get_kernel().init_theta())
    ranks = pool.submit("latent_objective", spec=spec, x=x, y=y, theta=theta)
    kernel = w.estimator(spec, jgp)._get_kernel()
    tol = spec["tol"]
    if family not in SCALED_GRAD:
        data = j_shard(j_group(x, y, S), eight_device_mesh)
        jv, jg, _ = j_lap.make_sharded_laplace_objective(kernel, data, tol, eight_device_mesh)(
            theta, jnp.zeros_like(data.y))
    else:
        whole = j_group(x, y, S)
        if family == "gpc_mc":
            y1h = jnp.asarray(np.eye(3)[np.asarray(whole.y).astype(int)]) * whole.mask[..., None]
            jv, jg, _ = j_mc.make_mc_objective(kernel, whole.x, y1h, whole.mask, tol)(
                theta, jnp.zeros_like(y1h))
        elif family == "poisson":
            jv, jg, _ = j_lg.make_generic_objective(
                j_lg.PoissonLikelihood(), kernel, whole.x, whole.y, whole.mask, tol)(
                theta, jnp.zeros_like(whole.y))
        else:
            jv, jg, _ = j_ep.make_ep_objective(kernel, whole, tol)(
                theta, (jnp.zeros_like(whole.y), jnp.zeros_like(whole.y)))
    value, grad = _same_on_every_rank(ranks())
    np.testing.assert_allclose(value[0], float(jv), rtol=1e-9)
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-9, atol=1e-9 * np.abs(jg).max())


@pytest.mark.parametrize("provider", ["random", "greedy"])
def test_fit_distributed_matches_jax(pool, eight_device_mesh, provider):
    """Regression; the classifiers' and count models' fits are held in
    test_torch_distributed.py."""
    x, y, xt = _data()
    spec = dict(SPEC, m_active=16, maxiter=4, provider=provider)
    ranks = pool.submit("fit", spec=spec, x=x, y=y, xt=xt, mode="distributed")
    est = w.estimator(spec, jgp).setMesh(eight_device_mesh)
    j_model = est.fit_distributed(j_shard(j_group(x, y, S), eight_device_mesh))
    port = _same_on_every_rank(ranks())
    _assert_fit_matches(port, j_model, xt)


def test_kmeans_from_the_stack_is_the_one_rank_selection(pool):
    """Sharded Lloyd over two ranks gives the one-rank centroids (its
    k-means++ seeds come from a torch generator, so not the JAX package's
    rows); theta does not depend on the active set and matches JAX's fit
    in test_fit_distributed_matches_jax."""
    x, y, xt = _data()
    spec = dict(SPEC, m_active=16, maxiter=4, provider="kmeans")
    ranks = pool.submit("fit", spec=spec, x=x, y=y, xt=xt, mode="distributed")
    alone = w.fit(None, spec, x, y, xt, mode="distributed")
    port = _same_on_every_rank(ranks())
    np.testing.assert_allclose(port[2], alone[2], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port[0], alone[0], rtol=1e-12)
    np.testing.assert_allclose(port[1], alone[1], rtol=1e-9, atol=1e-9)


def test_sharded_device_fit_matches_the_unsharded_device_fit(pool):
    x, y, xt = _data()
    spec = dict(SPEC, optimizer="device")
    ranks = pool.submit("fit", spec=spec, x=x, y=y, xt=xt, mode="mesh_fit")
    alone = w.fit(None, spec, x, y, xt, mode="mesh_fit")
    port = _same_on_every_rank(ranks())
    np.testing.assert_allclose(port[0], alone[0], rtol=1e-8)
    np.testing.assert_allclose(port[1], alone[1], rtol=1e-8, atol=1e-8)
    assert port[3][0] == alone[3][0]   # the same evaluations


def test_sharded_elbo_matches_jax(pool):
    """The ELBO over two ranks (the bound of the all-reduced sums, the
    all-reduced vector-Jacobian product) against the JAX package's
    ``batched_elbo_nll`` over the whole stack."""
    x, y, _ = _data()
    spec = dict(SPEC, sigma2=1e-2)
    theta = np.asarray(w.estimator(spec)._get_kernel().init_theta()) * 0.9
    active = x[::12]
    ranks = pool.submit("elbo", spec=spec, x=x, y=y, theta=theta, active=active, sigma2=1e-2)
    kernel = w.estimator(spec, jgp)._get_kernel()
    jv, jg = jax.jit(jax.value_and_grad(lambda t: j_sgpr.batched_elbo_nll(
        kernel, t, j_group(x, y, S), jnp.asarray(active), 1e-2)))(jnp.asarray(theta))
    value, grad = _same_on_every_rank(ranks())
    np.testing.assert_allclose(value[0], float(jv), rtol=1e-10)
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-10, atol=1e-10 * np.abs(jg).max())


#: fits over two ranks against the same fit unsharded: the device fits of
#: the latent families from zero latents on their labels (the inner loops'
#: tolerance tight enough that EP's per-rank stop of its sweeps does not
#: depend on the split), the ELBO on both optimizers, and fit-time
#: selection (GP_AGG_SELECT) on seven experts with duplicates (one padded)
MESH_FITS = {
    "gpc": {"family": "gpc"}, "gpc_mc": {"family": "gpc_mc"},
    "poisson": {"family": "poisson"}, "ep": {"family": "ep"},
    "elbo": {"family": "gpr", "objective": "elbo", "sigma2": 1e-2},
    "elbo-host": {"family": "gpr", "objective": "elbo", "sigma2": 1e-2, "optimizer": "host"},
    "select-drop": {"family": "gpr", "optimizer": "host"},
    "select-downweight": {"family": "gpr", "optimizer": "host"},
}


@pytest.mark.parametrize("name", list(MESH_FITS))
def test_sharded_fits_match_the_unsharded_fits(pool, name):
    x, y, xt = _data()
    spec = dict({"optimizer": "device"}, **MESH_FITS[name], p=P, s=S, m_active=16, maxiter=5,
                tol=1e-10)
    env = None
    if name.startswith("select"):
        x, y = _duplicated()
        env = {"GP_AGG_SELECT": "1", "GP_AGG_SELECT_MODE": name.split("-")[1]}
    elif spec["family"] != "gpr":
        y = _labels(spec["family"], x)
    ranks = pool.submit("fit", spec=spec, x=x, y=y, xt=xt, mode="mesh_fit", env=env)
    alone = w.fit(None, spec, x, y, xt, mode="mesh_fit", env=env)
    port = _same_on_every_rank(ranks())
    np.testing.assert_allclose(port[0], alone[0], rtol=1e-8)
    np.testing.assert_allclose(port[1], alone[1], rtol=1e-8, atol=1e-8 * np.abs(alone[1]).max())
    assert port[3][0] == alone[3][0]   # the same evaluations


def test_a_fit_over_the_threshold_solves_row_sharded(pool):
    """With ``ppa._DEVICE_SOLVE_MIN_M`` lowered to the active set's size,
    a two-rank fit runs the row-sharded magic solve once (the fit passes
    its mesh) and equals the unsharded fit's host solve."""
    x, y, xt = _data()
    spec = dict(SPEC, m_active=64, maxiter=4)
    ranks = pool.submit("row_sharded_fit", spec=spec, x=x, y=y, xt=xt, min_m=64)
    alone = w.fit(None, spec, x, y, xt)
    *port, calls = _same_on_every_rank(ranks())
    np.testing.assert_array_equal(calls, [64])
    np.testing.assert_allclose(port[0], alone[0], rtol=1e-8)
    np.testing.assert_allclose(port[1], alone[1], rtol=1e-8, atol=1e-8 * np.abs(alone[1]).max())


def _duplicated(e=7, s=S, seed=9):
    """Rows whose round-robin experts 1 and 4 repeat experts 0 and 3."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e * s, P))
    rows = np.arange(e * s)
    for dup, src in ((1, 0), (4, 3)):
        x[rows % e == dup] = x[rows % e == src]
    return x, np.sin(x @ np.array([1.0, 0.5, -0.7]))


@pytest.mark.parametrize("mode", ["drop", "downweight"])
def test_selection_over_the_mesh_matches_jax(pool, mode):
    """Seven experts over two ranks (one padded): the global report equals
    the JAX package's ``select_experts`` over the whole stack, the padded
    expert inactive."""
    x, y = _duplicated()
    ranks = pool.submit("select", x=x, y=y, s=S, mode=mode, seed=7)
    j_report = j_agg.select_experts(j_group(x, y, S), threshold=0.95, mode=mode, seed=7)
    drop, weights = _same_on_every_rank(ranks())
    np.testing.assert_array_equal(drop, np.append(j_report.drop, False))
    np.testing.assert_array_equal(weights, np.append(j_report.weights, 0.0))
    assert j_report.num_dropped == (2 if mode == "drop" else 0)


@pytest.mark.parametrize("mode", ["rbcm", "poe"])
def test_sharded_poe_matches_jax(pool, eight_device_mesh, mode):
    x, y, xt = _data()
    theta = _theta()
    ranks = pool.submit("poe", spec=SPEC, x=x, y=y, xt=xt, theta=theta, mode=mode)
    kernel = w.estimator(SPEC, jgp)._get_kernel()
    j_mean, j_var = j_poe(kernel, theta, x, y, S, mode=mode,
                          mesh=eight_device_mesh).predict_with_var(xt)
    mean, var = _same_on_every_rank(ranks())
    np.testing.assert_allclose(mean, np.asarray(j_mean), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(var, np.asarray(j_var), rtol=1e-9)


def test_a_gloo_mesh_without_a_device_is_on_the_card(pool):
    """Under gloo as under NCCL, and without a group, the mesh's device is
    the card unless the caller passes ``device="cpu"``; a host without a
    card raises, never quietly running the fit on the CPU."""
    for got in pool.run("default_device") + [w.default_device(None)]:
        if torch.cuda.is_available():
            assert got.startswith("cuda:"), got
        else:
            assert got.startswith("raised: no CUDA device"), got
    assert expert_mesh(device="cpu").device == torch.device("cpu")
