"""The port's Laplace engine (``models/laplace.py``) and the iterative
lane's B-system solvers (``ops/iterative.py``) against the JAX package's,
float64 on the CPU, on the same seeded inputs: the 30-point, 2-feature
problem of the JAX package's Laplace tests, grouped into E = 3 experts.
Bars: the mode and ``-log Z`` within 1e-8 relative, the gradient within
1e-6 (and against central finite differences); the exact lane's
inverse branch (K1's, through its plain version) against its Cholesky
branch; padding, the warm start and the launch count; ``spd_solve`` /
``spd_logdet`` with the JAX probes injected, at preconditioner rank 16
below s (tests/_torch_solver_helpers.py says why)."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import laplace as j_lap
from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import laplace as t_lap
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import ExpertData
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

TOL = 1e-8

# the JAX side under jit: one compile a shape instead of op-by-op dispatch
J_NEG_LOGZ = jax.jit(j_lap.batched_neg_logz, static_argnums=(0, 1))
J_MODE = jax.jit(j_lap.laplace_mode, static_argnums=(4,))
J_EXPERT = jax.jit(j_lap.expert_neg_logz_and_grad, static_argnums=(0, 1))
J_SOLVE = jax.jit(j_it.spd_solve)
J_LOGDET = jax.jit(j_it.spd_logdet)


def _kernel(m, family):
    if family == "rbf":
        return m.RBFKernel(1.0) + m.Const(1e-3) * m.EyeKernel()
    return 1.0 * m.ARDRBFKernel(2) + m.Const(1e-3) * m.EyeKernel()


def _problem(n=30, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    return x, y


def _both(x, y, expert, family, theta_scale=1.0):
    jk, tk = _kernel(jgp, family), _kernel(tgp, family)
    theta = jk.init_theta() * theta_scale
    jd = j_group(x, y, expert)
    td = t_group(x, y, expert, dtype=torch.float64)
    return (jk, jd, jnp.asarray(theta)), (tk, td, torch.as_tensor(theta))


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("family", ["rbf", "ard"])
@pytest.mark.parametrize("theta_scale", [1.0, 1.6])
def test_batched_neg_logz_matches_jax(family, theta_scale):
    x, y = _problem()
    (jk, jd, jth), (tk, td, tth) = _both(x, y, 10, family, theta_scale)
    assert tuple(td.x.shape) == (3, 10, 2)
    jv, jg, jf = J_NEG_LOGZ(jk, TOL, jth, jd, jnp.zeros_like(jd.y))
    tv, tg, tf = t_lap.batched_neg_logz(tk, TOL, tth, td, torch.zeros_like(td.y))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-6


@pytest.mark.parametrize("family", ["rbf", "ard"])
def test_gradient_matches_central_differences(family):
    x, y = _problem()
    _, (tk, td, tth) = _both(x, y, 10, family, 1.3)
    f0 = torch.zeros_like(td.y)
    _, grad, _ = t_lap.batched_neg_logz(tk, 1e-12, tth, td, f0)
    h = 1e-6
    fd = []
    for i in range(tth.shape[0]):
        step = torch.zeros_like(tth)
        step[i] = h
        up = t_lap.batched_neg_logz(tk, 1e-12, tth + step, td, f0)[0].item()
        down = t_lap.batched_neg_logz(tk, 1e-12, tth - step, td, f0)[0].item()
        fd.append((up - down) / (2 * h))
    np.testing.assert_allclose(grad.numpy(), fd, rtol=1e-6, atol=1e-8)


def test_single_expert_wrappers_match_jax():
    x, y = _problem()
    (jk, _, jth), (tk, _, tth) = _both(x, y, 10, "rbf")
    kmat = np.array(jk.gram(jth, jnp.asarray(x)))
    mask = np.ones(len(y))
    jf, jo = J_MODE(jnp.asarray(kmat), jnp.asarray(y), jnp.asarray(mask),
                                jnp.zeros(len(y)), 1e-10)
    tf, to = t_lap.laplace_mode(torch.as_tensor(kmat), torch.as_tensor(y),
                                torch.as_tensor(mask), torch.zeros(len(y), dtype=torch.float64),
                                1e-10)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(to.item(), float(jo), rtol=1e-10)
    jv, jg, jf = J_EXPERT(jk, TOL, jth, jnp.asarray(x), jnp.asarray(y),
                                                jnp.asarray(mask), jnp.zeros(len(y)))
    tv, tg, tf = t_lap.expert_neg_logz_and_grad(tk, TOL, tth, torch.as_tensor(x),
                                                torch.as_tensor(y), torch.as_tensor(mask),
                                                torch.zeros(len(y), dtype=torch.float64))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-8, atol=1e-12)


def test_host_objective_matches_jax_and_warm_starts():
    """``make_laplace_objective`` gives the JAX objective's float and
    float64 gradient; a second call from the returned modes lands on the
    same value with fewer Newton iterations."""
    x, y = _problem()
    (jk, jd, jth), (tk, td, tth) = _both(x, y, 10, "ard")
    theta = np.array(jth)
    jobj = j_lap.make_laplace_objective(jk, jd, 1e-6)
    tobj = t_lap.make_laplace_objective(tk, td, 1e-6)
    jv, jg, jf = jobj(theta, jnp.zeros_like(jd.y))
    before = t_lap.laplace_mode_batch.iterations
    tv, tg, tf = tobj(theta, torch.zeros_like(td.y))
    cold = t_lap.laplace_mode_batch.iterations - before
    assert isinstance(tv, float) and tg.dtype == np.float64
    np.testing.assert_allclose(tv, float(jv), rtol=1e-8)
    assert _rel(tg, jg) <= 1e-6
    before = t_lap.laplace_mode_batch.iterations
    tv2, _, tf2 = tobj(theta, tf)
    warm = t_lap.laplace_mode_batch.iterations - before
    np.testing.assert_allclose(tv2, tv, rtol=1e-8)
    np.testing.assert_allclose(tf2.numpy(), tf.numpy(), rtol=1e-6, atol=1e-9)
    assert 1 <= warm < cold


def test_inverse_branch_matches_cholesky_branch(monkeypatch):
    """The card's branch (K1's ``B^-1`` and ``log|B|``) forced on the CPU,
    where the wrapper runs K1's plain version, against the Cholesky
    branch; and K1 runs once a Newton iteration plus once an evaluation."""
    x, y = _problem()
    _, (tk, td, tth) = _both(x, y, 8, "rbf")
    f0 = torch.zeros_like(td.y)
    v_chol, g_chol, f_chol = t_lap.batched_neg_logz(tk, 1e-10, tth, td, f0)

    calls = []

    def counted(k):
        calls.append(tuple(k.shape))
        return spd_linalg.spd_inv_logdet_plain(k)

    monkeypatch.setattr(spd_linalg, "kernel_applies", lambda k: True)
    monkeypatch.setattr(spd_linalg, "spd_inv_logdet", counted)
    before = t_lap.laplace_mode_batch.iterations
    v_inv, g_inv, f_inv = t_lap.batched_neg_logz(tk, 1e-10, tth, td, f0)
    iterations = t_lap.laplace_mode_batch.iterations - before
    np.testing.assert_allclose(v_inv.item(), v_chol.item(), rtol=1e-10)
    np.testing.assert_allclose(g_inv.numpy(), g_chol.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(f_inv.numpy(), f_chol.numpy(), rtol=1e-9, atol=1e-11)
    assert len(calls) == iterations + 1 and iterations > 1
    assert set(calls) == {tuple(td.x.shape[:2]) + (td.x.shape[1],)}


def test_padding_rows_change_nothing():
    """Three padded slots an expert (arbitrary rows, mask 0) leave the
    value, the gradient and the real points' modes as they were, and
    their own modes at 0."""
    x, y = _problem()
    _, (tk, td, tth) = _both(x, y, 10, "ard", 1.2)
    rng = np.random.default_rng(3)
    pad = torch.as_tensor(rng.normal(size=(3, 3, 2)))
    padded = ExpertData(
        x=torch.cat([td.x, pad], dim=1),
        y=torch.cat([td.y, torch.ones(3, 3, dtype=torch.float64)], dim=1),
        mask=torch.cat([td.mask, torch.zeros(3, 3, dtype=torch.float64)], dim=1),
    )
    v, g, f = t_lap.batched_neg_logz(tk, TOL, tth, td, torch.zeros_like(td.y))
    vp, gp, fp = t_lap.batched_neg_logz(tk, TOL, tth, padded, torch.zeros_like(padded.y))
    np.testing.assert_allclose(vp.item(), v.item(), rtol=1e-12)
    np.testing.assert_allclose(gp.numpy(), g.numpy(), rtol=1e-10)
    np.testing.assert_allclose(fp[:, :10].numpy(), f.numpy(), rtol=1e-10, atol=1e-14)
    assert torch.all(fp[:, 10:] == 0)


def test_float32_stack_runs_and_stops():
    """The float32 stack (the card's dtype) converges under tol 1e-3 to
    the float64 value within float32's reach."""
    x, y = _problem()
    _, (tk, td, tth) = _both(x, y, 10, "rbf")
    v64, g64, _ = t_lap.batched_neg_logz(tk, 1e-3, tth, td, torch.zeros_like(td.y))
    d32 = ExpertData(x=td.x.float(), y=td.y.float(), mask=td.mask.float())
    v32, g32, f32 = t_lap.batched_neg_logz(tk, 1e-3, tth.float(), d32, torch.zeros_like(d32.y))
    assert f32.dtype == torch.float32 and torch.isfinite(f32).all()
    np.testing.assert_allclose(v32.item(), v64.item(), rtol=1e-5)
    np.testing.assert_allclose(g32.double().numpy(), g64.numpy(), rtol=1e-3)


# --- the iterative lane's B-system solvers -------------------------------


def _b_stack(e=2, s=30, seed=5):
    """``B = I + sqrtW K sqrtW`` of an RBF gram at a latent draw."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, s, 2))
    d = np.sum((x[:, :, None, :] - x[:, None, :, :]) ** 2, axis=-1)
    k = np.exp(-0.5 * d)
    pi = 1.0 / (1.0 + np.exp(-rng.normal(size=(e, s))))
    sqw = np.sqrt(pi * (1.0 - pi))
    return np.eye(s) + sqw[:, :, None] * k * sqw[:, None, :]


def test_spd_solve_and_logdet_match_jax(solver_env):
    b = _b_stack()
    rhs = np.random.default_rng(6).normal(size=(2, 30, 3))
    jb, tb = jnp.asarray(b), torch.as_tensor(b)
    jpre = j_it.build_spd_preconditioner(jb)
    tpre = t_it.build_spd_preconditioner(tb)
    for jp, tp in zip(jpre, tpre):
        assert _rel(tp.numpy(), jp) <= 1e-10
    for r in (rhs[..., 0], rhs):
        want = J_SOLVE(jb, jnp.asarray(r))
        assert _rel(t_it.spd_solve(tb, torch.as_tensor(r)).numpy(), want) <= 1e-9
        assert _rel(t_it.spd_solve(tb, torch.as_tensor(r), precond=tpre).numpy(), want) <= 1e-9
        dense = np.linalg.solve(b, r if r.ndim == 3 else r[..., None])
        np.testing.assert_allclose(np.asarray(want), dense.reshape(r.shape), rtol=1e-8,
                                   atol=1e-10)
    want = np.asarray(J_LOGDET(jb))
    np.testing.assert_allclose(t_it.spd_logdet(tb).numpy(), want, rtol=1e-9)
    np.testing.assert_allclose(t_it.spd_logdet(tb, precond=tpre).numpy(), want, rtol=1e-9)


def test_spd_solve_and_logdet_gradients_match_jax(solver_env):
    """``spd_solve`` differentiates by solving again (the exact implicit
    gradient), ``spd_logdet`` by its Hutchinson surrogate: both against
    JAX's gradients of the same functions."""
    b = _b_stack(seed=7)
    gen = np.random.default_rng(8)
    r, c = gen.normal(size=(2, 30)), gen.normal(size=(2, 30))
    jgrads = jax.jit(jax.grad(
        lambda a, v: jnp.sum(jnp.asarray(c) * j_it.spd_solve(a, v)), argnums=(0, 1)
    ))(jnp.asarray(b), jnp.asarray(r))
    tb = torch.as_tensor(b).requires_grad_(True)
    tr = torch.as_tensor(r).requires_grad_(True)
    torch.sum(torch.as_tensor(c) * t_it.spd_solve(tb, tr)).backward()
    assert _rel(tb.grad.numpy(), jgrads[0]) <= 1e-8
    assert _rel(tr.grad.numpy(), jgrads[1]) <= 1e-8
    jg = jax.jit(jax.grad(lambda a: jnp.sum(j_it.spd_logdet(a))))(jnp.asarray(b))
    tb = torch.as_tensor(b).requires_grad_(True)
    torch.sum(t_it.spd_logdet(tb)).backward()
    assert _rel(tb.grad.numpy(), jg) <= 1e-8


@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_iterative_lane_neg_logz_matches_jax(solver_env, lane):
    """On the iterative lanes (matfree resolves to the same materialized B
    solves) the Newton loop, the full inverse and the SLQ log-det run on
    CG; both packages on the same probes, at s = 30 > rank 16."""
    x, y = _problem(n=60)
    (jk, jd, jth), (tk, td, tth) = _both(x, y, 30, "rbf", 1.2)
    assert tuple(td.x.shape) == (2, 30, 2)
    j_it.set_solver_lane(lane)
    t_it.set_solver_lane(lane)
    # a fresh jit: the JAX package reads the lane while it traces
    jv, jg, jf = jax.jit(j_lap.batched_neg_logz, static_argnums=(0, 1))(
        jk, TOL, jth, jd, jnp.zeros_like(jd.y))
    tv, tg, tf = t_lap.batched_neg_logz(tk, TOL, tth, td, torch.zeros_like(td.y))
    assert _rel(tf.numpy(), jf) <= 1e-8
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-6
