"""The row-sharded Cholesky and the sharded magic solve of the port
(``ops/dist_linalg.py``, ``models/ppa.sharded_magic_solve``): three gloo
ranks on the CPU, started once for this file
(``_torch_mesh_worker.MeshPool``), against the JAX package's
``dist_linalg`` and ``ppa.sharded_magic_solve`` on the 8-device CPU mesh
(``tests/conftest.py``), numpy and the port's host solve, in float64.
Tolerances: the factor and the solves 1e-10; the magic vector rtol 1e-8,
atol 1e-10 (the JAX package's own parity test's); the magic matrix rtol
1e-8, atol 1e-10 of its largest entry (its entries span five orders of
magnitude; the JAX package's test holds it at rtol 1e-6, atol 1e-8)."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as w
from spark_gp_tpu import Const as JConst
from spark_gp_tpu import EyeKernel as JEyeKernel
from spark_gp_tpu import RBFKernel as JRBFKernel
from spark_gp_tpu.models import ppa as j_ppa
from spark_gp_tpu.ops import dist_linalg as j_dl
from spark_gp_tpu.resilience import integrity as j_integrity
from spark_gp_tpu_torch import Const, EyeKernel, RBFKernel
from spark_gp_tpu_torch.models import ppa
from spark_gp_tpu_torch.ops import dist_linalg as dl
from spark_gp_tpu_torch.resilience import chaos, integrity

WORLD, BLOCK = 3, 16
M = 384   # a multiple of 3 x 16 (the port's ranks) and of 8 x 16 (the JAX mesh)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = w.MeshPool(WORLD, tmp_path_factory.mktemp("dist_linalg"))
    yield ranks
    ranks.close()


def _spd(m, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, m))
    return g @ g.T / m + np.eye(m)


def _same_on_every_rank(results):
    for r in results[1:]:
        for a, b in zip(results[0], r):
            np.testing.assert_array_equal(a, b)
    return results[0]


def test_sharded_cholesky_and_solves_match_jax_and_numpy(pool, eight_device_mesh):
    """The factor, and solves of a vector, a matrix and the identity; then a
    300 x 300 matrix padded to 384 (``pad_spd``), its solution sliced back."""
    a = _spd(M)
    rng = np.random.default_rng(1)
    vec, mat = rng.normal(size=M), rng.normal(size=(M, 5))
    small = _spd(300, seed=2)
    padded = dl.pad_spd(small, M)
    rhs_small = np.concatenate([rng.normal(size=(300, 2)), np.zeros((M - 300, 2))])
    ranks = pool.submit("dist_chol", a=a, rhs=[vec, mat, np.eye(M)], block=BLOCK)
    with jax.enable_x64():
        j_chol = j_dl.sharded_cholesky(eight_device_mesh, jnp.asarray(a), BLOCK)
        j_sols = [np.asarray(j_dl.sharded_chol_solve(eight_device_mesh, j_chol, jnp.asarray(r),
                                                     BLOCK)) for r in (vec, mat, np.eye(M))]
        j_chol = np.asarray(j_chol)
    chol, *sols = _same_on_every_rank(ranks())
    ranks_pad = pool.submit("dist_chol", a=padded, rhs=[rhs_small], block=BLOCK)
    np.testing.assert_allclose(chol, np.linalg.cholesky(a), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(chol, j_chol, rtol=1e-10, atol=1e-10)
    for got, j_got, rhs in zip(sols, j_sols, (vec, mat, np.eye(M))):
        np.testing.assert_allclose(got, np.linalg.solve(a, rhs), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got, j_got, rtol=1e-10, atol=1e-10)
    _, sol_pad = _same_on_every_rank(ranks_pad())
    np.testing.assert_allclose(sol_pad[:300], np.linalg.solve(small, rhs_small[:300]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(sol_pad[300:], 0.0)


def test_a_size_off_the_granularity_raises_on_every_rank(pool):
    for got in pool.run("dist_chol", a=_spd(100), rhs=[], block=BLOCK):
        assert got.startswith("raised ValueError: m=100 must be a multiple of "
                              "world_size*block=48"), got


def _rbf_gram(m=M, jitter=1e-6, seed=6):
    """An ill-conditioned SPD matrix: an RBF gram of uniform points plus
    ``jitter``; a corrupted rank's panels turn later panels indefinite
    (NaN in every rank's copy) on it."""
    x = np.random.default_rng(seed).uniform(size=(m, 3))
    return np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1) / 0.25) + jitter * np.eye(m)


@pytest.mark.parametrize("case, corrupt", [("spd", 2), ("ill_conditioned", 1)])
def test_the_panel_tripwire_names_the_corrupted_rank_on_every_rank(pool, case, corrupt):
    """At ``GP_INTEGRITY_PANEL_SAMPLE=1``: a clean factor counts its panel
    checks, every copy equal to the others bit for bit;
    ``corrupt_device(rank)`` raises ``PanelMismatchError`` naming the rank
    on every rank (the JAX package's tests/test_integrity.py case), also
    where the corruption makes later panels NaN on every rank (a NaN panel
    must not erase the verdict of an earlier one); at ``GP_INTEGRITY=0``
    the same corruption passes silently."""
    a = _spd(M, seed=3) if case == "spd" else _rbf_gram()
    results = pool.run("tripwire", a=a, block=BLOCK, corrupt=corrupt)
    exact = np.linalg.cholesky(a)
    for clean, checks, spread, verdict, silent in results:
        np.testing.assert_allclose(clean, exact, rtol=1e-10, atol=1e-10)
        assert checks == M // BLOCK
        assert spread == 0.0   # honest copies agree bit for bit
        assert verdict == (corrupt, "panel_divergence", "sdc")
        assert not np.allclose(silent, exact)


def _magic_case(m=300, seed=0):
    """JAX tests/test_ppa.py::test_sharded_magic_solve_matches_host's case."""
    rng = np.random.default_rng(seed)
    active = rng.normal(size=(m, 3))
    b = rng.normal(size=(m, m)) / np.sqrt(m)
    return active, b @ b.T * m * 0.01, rng.normal(size=m)


def test_sharded_magic_solve_matches_jax_and_the_host_solve(pool, eight_device_mesh):
    active, u1, u2 = _magic_case()
    full = pool.submit("magic", length=1.5, noise=1e-3, active=active, u1=u1, u2=u2,
                       block=BLOCK)
    j_kernel = JRBFKernel(1.5) + JConst(1e-3) * JEyeKernel()
    j_mv, j_mm = j_ppa.sharded_magic_solve(j_kernel, np.asarray(j_kernel.init_theta()), active,
                                           u1, u2, eight_device_mesh, block=BLOCK)
    kernel = RBFKernel(1.5) + Const(1e-3) * EyeKernel()
    h_mv, h_mm = ppa._host_magic_solve(kernel, kernel.init_theta(), active, u1, u2)
    mv, mm, warned = _same_on_every_rank(full())
    mean_only = pool.submit("magic", length=1.5, noise=1e-3, active=active, u1=u1, u2=u2,
                            block=BLOCK, with_variance=False)
    assert warned == []
    for ref_mv, ref_mm in ((np.asarray(j_mv), np.asarray(j_mm)), (h_mv, h_mm)):
        np.testing.assert_allclose(mv, ref_mv, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(mm, ref_mm, rtol=1e-8, atol=1e-10 * np.abs(ref_mm).max())
    mv_mean, mm_mean, _ = _same_on_every_rank(mean_only())
    assert mm_mean is None
    np.testing.assert_array_equal(mv_mean, mv)


def test_a_pd_that_needs_jitter_takes_the_jax_rung(pool, eight_device_mesh, caplog):
    """``PD = C - delta I`` with ``C`` of rank 250 < m: indefinite until the
    trace-relative jitter passes delta, at the rung 1.2e-5 of the schedule
    (delta = 5e-6 of trace / m).  The JAX sharded solve walks PD and K_mm
    together, so its mean-only solve (PD alone) is held here."""
    m = 300
    active, _, u2 = _magic_case(m, seed=4)
    kernel = RBFKernel(1.5) + Const(1e-3) * EyeKernel()
    theta = torch.as_tensor(kernel.init_theta())
    pd_part = float(kernel.white_noise_var(theta)) * kernel.gram(theta,
                                                                 torch.as_tensor(active)).numpy()
    c = np.random.default_rng(5).normal(size=(m, 250))
    c = c @ c.T / m
    u1 = c - pd_part - 5e-6 * np.trace(c) / m * np.eye(m)
    ranks = pool.submit("magic", length=1.5, noise=1e-3, active=active, u1=u1, u2=u2,
                        block=BLOCK, with_variance=False)
    j_kernel = JRBFKernel(1.5) + JConst(1e-3) * JEyeKernel()
    with caplog.at_level(logging.WARNING, logger="spark_gp_tpu"):
        j_mv, _ = j_ppa.sharded_magic_solve(j_kernel, np.asarray(j_kernel.init_theta()), active,
                                            u1, u2, eight_device_mesh, block=BLOCK,
                                            with_variance=False)
    j_rung = [r.getMessage() for r in caplog.records if "required relative jitter" in r.message]
    h_mv, _ = ppa._host_magic_solve(kernel, kernel.init_theta(), active, u1, u2, False)
    mv, _, warned = _same_on_every_rank(ranks())
    assert j_rung and j_rung[0].endswith("1.200e-05 for positive definiteness")
    assert warned == ["sharded magic solve: PD required relative jitter 1.200e-05 for "
                      "positive definiteness"]
    np.testing.assert_allclose(mv, np.asarray(j_mv), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mv, h_mv, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_the_tripwire_samples_the_jax_panels(rate):
    assert [integrity.panel_checked(k, rate) for k in range(256)] == \
        [j_integrity.panel_checked(k, rate) for k in range(256)]


def test_the_staged_corruption_reads_its_environment_channel(monkeypatch):
    assert chaos.staged_device_corruption() is None
    monkeypatch.setenv("GP_CHAOS_CORRUPT_DEVICE", "1")
    assert chaos.staged_device_corruption() == (1, 1e3)
    monkeypatch.setenv("GP_CHAOS_CORRUPT_SCALE", "7")
    assert chaos.staged_device_corruption() == (1, 7.0)
    with chaos.corrupt_device(2, scale=3.0):
        assert chaos.staged_device_corruption() == (2, 3.0)
    monkeypatch.setenv("GP_INTEGRITY_PANEL_SAMPLE", "0.5")
    assert integrity.panel_sample_rate() == 0.5 and integrity.enabled()
    monkeypatch.setenv("GP_INTEGRITY", "off")
    assert not integrity.enabled()

