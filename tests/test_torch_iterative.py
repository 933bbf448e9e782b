"""The port's iterative solver engine (``ops/iterative.py``) against the
JAX package's, float64, on fixed SPD stacks with a preconditioner rank
below s: the pivoted Cholesky, Woodbury, batched PCG and SLQ within
1e-10; ``inv_quad_logdet`` (materialized and matfree) and
``solver_report`` with the JAX probes injected within 1e-9 relative; and
the lane policy."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu_torch.ops import iterative as t_it

E, S, RANK = 3, 40, 12
# the engine's knobs, passed to both packages: rank below s and CG run to
# convergence (tests/_torch_solver_helpers.py says why)
CFG = (40, 8, 16, 1e-12, 0)


def _spd(seed=0, e=E, s=S, ridge=0.05):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(e, s, s))
    return a @ a.transpose(0, 2, 1) / s + ridge * np.eye(s)


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-300)


def _precond(k, rank=RANK):
    jl, jd = j_it.pivoted_cholesky(jnp.asarray(k), rank)
    tl, td = t_it.pivoted_cholesky(torch.as_tensor(k), rank)
    return (jl, jd, j_it.woodbury_factor(jl, jd)), (tl, td, t_it.woodbury_factor(tl, td))


def test_pivoted_cholesky_and_woodbury_match_jax():
    k = _spd()
    (jl, jd, jc), (tl, td, tc) = _precond(k)
    assert tl.shape == (E, S, RANK)
    assert _rel(tl.numpy(), jl) <= 1e-10 and _rel(td.numpy(), jd) <= 1e-10
    assert _rel(tc.numpy(), jc) <= 1e-10
    v = np.random.default_rng(1).normal(size=(E, S, 4))
    assert _rel(t_it.woodbury_apply(tl, td, tc, torch.as_tensor(v)).numpy(),
                j_it.woodbury_apply(jl, jd, jc, jnp.asarray(v))) <= 1e-10
    assert _rel(t_it.woodbury_logdet(tl, td, tc).numpy(), j_it.woodbury_logdet(jl, jd, jc)) <= 1e-10
    # the column-oracle entry point is the same recurrence
    kt = torch.as_tensor(k)
    col = lambda piv: kt[torch.arange(E), :, piv]  # noqa: E731
    l2, d2 = t_it.pivoted_cholesky_cols(torch.diagonal(kt, dim1=-2, dim2=-1), col, RANK)
    assert torch.equal(l2, tl) and torch.equal(d2, td)


@pytest.mark.parametrize("iters", [1, 8, 40])
def test_batched_pcg_matches_jax(iters):
    """Every record after 1 and 8 steps, before convergence, within 1e-10.
    Run to convergence (40 steps at tolerance 1e-12), the solution and the
    residuals within 1e-10; the last coefficients are then rounding noise
    (each package may freeze a column one step apart), so they are left
    out there."""
    k = _spd(2, ridge=0.5)
    rhs = np.random.default_rng(3).normal(size=(E, S, 5))
    (jl, jd, jc), (tl, td, tc) = _precond(k)
    jr = j_it.batched_pcg(lambda v: jnp.einsum("...st,...tn->...sn", jnp.asarray(k), v),
                          jnp.asarray(rhs), precond=lambda v: j_it.woodbury_apply(jl, jd, jc, v),
                          iters=iters, tol=1e-12)
    tr = t_it.batched_pcg(lambda v: torch.as_tensor(k) @ v, torch.as_tensor(rhs),
                          precond=lambda v: t_it.woodbury_apply(tl, td, tc, v),
                          iters=iters, tol=1e-12)
    names = ("x", "rel_resid") if iters == 40 else ("x", "alphas", "betas", "rel_resid", "iters_used")
    assert iters < 40 or tr.rel_resid.max().item() < 1e-11
    for name in names:
        got, want = getattr(tr, name).numpy(), np.asarray(getattr(jr, name))
        assert got.shape == want.shape, name
        assert np.max(np.abs(got - want)) <= 1e-10 * max(np.max(np.abs(want)), 1.0), name


def test_slq_from_given_coefficients_matches_jax():
    rng = np.random.default_rng(4)
    alphas = rng.uniform(0.5, 2.0, size=(10, E, 6))
    betas = rng.uniform(0.0, 0.6, size=(10, E, 6))
    betas[7:, 1] = 0.0  # a frozen tail
    weights = rng.uniform(1.0, 3.0, size=(E, 6))
    want = j_it.slq_logdet_from_coeffs(jnp.asarray(alphas), jnp.asarray(betas), jnp.asarray(weights))
    got = t_it.slq_logdet_from_coeffs(torch.as_tensor(alphas), torch.as_tensor(betas),
                                      torch.as_tensor(weights))
    assert _rel(got.numpy(), want) <= 1e-10


def test_inv_quad_logdet_both_engines_match_jax(solver_env):
    """Values and gradients with respect to the stack, through the
    materialized engine and through the injected-operator engine."""
    k = _spd(5)
    y = np.random.default_rng(6).normal(size=(E, S))
    j_cfg, t_cfg = j_it.SolverConfig(*CFG), t_it.SolverConfig(*CFG)

    def j_loss(km):
        q, ld = j_it.inv_quad_logdet(km, jnp.asarray(y), j_cfg)
        return jnp.sum(q) + jnp.sum(ld), (q, ld)

    (_, (j_q, j_ld)), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jnp.asarray(k))
    km = torch.as_tensor(k).requires_grad_(True)
    t_q, t_ld = t_it.inv_quad_logdet(km, torch.as_tensor(y), t_cfg)
    (t_g,) = torch.autograd.grad(t_q.sum() + t_ld.sum(), km)
    assert _rel(t_q.detach().numpy(), j_q) <= 1e-9 and _rel(t_ld.detach().numpy(), j_ld) <= 1e-9
    assert _rel(t_g.numpy(), j_g) <= 1e-9

    kt = torch.as_tensor(k)
    col = lambda piv: kt[torch.arange(E), :, piv]  # noqa: E731
    m_q, m_ld = t_it.inv_quad_logdet_matfree(
        lambda v: kt @ v, lambda v: kt @ v, torch.diagonal(kt, dim1=-2, dim2=-1), col,
        torch.as_tensor(y), t_cfg)
    assert _rel(m_q.numpy(), j_q) <= 1e-9 and _rel(m_ld.numpy(), j_ld) <= 1e-9


def test_solver_report_matches_jax(solver_env):
    k = _spd(7)
    y = np.random.default_rng(8).normal(size=(E, S))
    want = j_it.solver_report(jnp.asarray(k), jnp.asarray(y), j_it.SolverConfig(*CFG))
    got = t_it.solver_report(torch.as_tensor(k), torch.as_tensor(y), t_it.SolverConfig(*CFG))
    assert set(got) == set(want)
    for key, value in want.items():
        # a converged residual is rounding noise: both sit under 1e-10
        tol = 1e-10 if key == "residual" else 1e-14
        assert got[key] == pytest.approx(value, rel=1e-9, abs=tol), key
    with pytest.raises(ValueError, match="operator mode"):
        t_it.solver_report(None, torch.as_tensor(y))


def test_lane_policy(solver_env, monkeypatch):
    assert t_it.active_solver_lane() == "exact"
    monkeypatch.setenv("GP_SOLVER_LANE", "iterative")
    assert t_it.active_solver_lane() == "iterative"
    assert t_it.set_solver_lane("matfree") is None
    assert t_it.active_solver_lane() == "matfree"
    with t_it.solver_lane_scope("exact"):
        assert t_it.active_solver_lane() == "exact"
    assert t_it.set_solver_lane("auto") == "matfree"
    assert t_it.resolve_solver(1023) == "exact" and t_it.resolve_solver(1024) == "iterative"
    monkeypatch.setenv("GP_SOLVER_AUTO_THRESHOLD", "100")
    assert t_it.resolve_solver(100) == j_it.resolve_solver(100, "auto") == "iterative"
    assert t_it.resolve_solver(50, "matfree") == "matfree"
    with pytest.raises(ValueError, match="not a solver lane"):
        t_it.set_solver_lane("cholesky")
    monkeypatch.setenv("GP_SOLVER_MAX_ITERS", "7")
    monkeypatch.setenv("GP_SOLVER_PROBES", "3")
    monkeypatch.setenv("GP_SOLVER_SEED", "5")
    assert t_it.solver_config(30) == tuple(j_it.solver_config(30))
    assert t_it.solver_config(4065) == (7, 3, 16, 1e-12, 5)
    assert t_it.solver_config(S) == tuple(j_it.solver_config(S))
