"""The port's aggregation plane (``models/aggregation.py``) and the
``weights`` operand of every fit objective against the JAX package's,
float64 on the CPU.  Bars: the sketches and the redundancy matrix within
1e-12; ``select_experts`` the same ``drop`` and ``weights`` exactly; the
weighted marginal NLL and gradient within 1e-10 on the exact lane and
1e-8 on the iterative and matfree lanes (their parity tests' bar, JAX
probes injected); the weighted LOO and the binary, multiclass, EP and
generic Laplace objectives within 1e-8 (value) and 1e-6 / 1e-8
(gradient), their parity tests' bars; a selection fit's theta at rtol
1e-5, as the regression fit test."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models import aggregation as j_agg
from spark_gp_tpu.models import ep as j_ep
from spark_gp_tpu.models import laplace as j_lap
from spark_gp_tpu.models import laplace_generic as j_lg
from spark_gp_tpu.models import laplace_mc as j_mc
from spark_gp_tpu.models import loo as j_loo
from spark_gp_tpu.models.gpc_mc import _one_hot_masked as j_one_hot
from spark_gp_tpu.models.likelihood import make_value_and_grad as j_vag
from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.models import aggregation as t_agg
from spark_gp_tpu_torch.models import ep as t_ep
from spark_gp_tpu_torch.models import laplace as t_lap
from spark_gp_tpu_torch.models import laplace_generic as t_lg
from spark_gp_tpu_torch.models import laplace_mc as t_mc
from spark_gp_tpu_torch.models import loo as t_loo
from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked as t_one_hot
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad as t_vag
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group
from spark_gp_tpu_torch.resilience.quarantine import ExpertQuarantineError, renorm_factor

TOL = 1e-6
WEIGHTS = np.array([0.5, 1.0, 0.25, 0.0, 1.0])  # one per expert of _problem()


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-300)


def _duplicated(base_n=160, seed=0):
    """Pairwise-duplicated rows: with an even expert count, expert 2j + 1
    holds exactly expert 2j's points."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(base_n, 2))
    yb = np.sin(xb.sum(axis=1)) + 0.05 * rng.normal(size=base_n)
    return np.repeat(xb, 2, axis=0), np.repeat(yb, 2)


def _problem(n=149, seed=0):
    """E = 5 experts of s = 30, one padded slot."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    y = np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=n)
    return x, y


@pytest.fixture
def no_agg_env(monkeypatch):
    for var in ("GP_AGG_POLICY", "GP_AGG_SELECT", "GP_AGG_SELECT_MODE",
                "GP_AGG_SELECT_THRESHOLD", "GP_AGG_SKETCH_DIM"):
        monkeypatch.delenv(var, raising=False)
    j_agg.set_agg_policy(None)
    t_agg.set_agg_policy(None)
    yield monkeypatch
    j_agg.set_agg_policy(None)
    t_agg.set_agg_policy(None)


# -- sketches, redundancy, selection ---------------------------------------


STACKS = {
    "duplicated": lambda: (*_duplicated(), 40),
    "independent": lambda: (*_problem(n=240), 40),
    "masked": lambda: (*_duplicated(), 40),
}


def _stacks(name):
    x, y, s = STACKS[name]()
    jd, td = j_group(x, y, s), t_group(x, y, s)
    if name == "masked":  # expert 0 already quarantined
        drop = np.arange(jd.num_experts) == 0
        jd, td = jd.with_experts_masked(drop), td.with_experts_masked(drop)
    return jd, td


@pytest.mark.parametrize("name", sorted(STACKS))
def test_sketches_and_redundancy_match_jax(name):
    jd, td = _stacks(name)
    js, ts = j_agg.expert_sketches(jd, seed=3), t_agg.expert_sketches(td, seed=3)
    assert _rel(ts, js) <= 1e-12
    j_sim = j_agg.redundancy_matrix(js)
    assert np.max(np.abs(t_agg.redundancy_matrix(ts, device="cpu") - j_sim)) <= 1e-12
    assert np.max(np.abs(t_agg.redundancy_matrix_host(ts) - j_sim)) <= 1e-12


@pytest.mark.parametrize("name", sorted(STACKS))
@pytest.mark.parametrize("mode", ["drop", "downweight"])
def test_select_experts_matches_jax(name, mode, no_agg_env):
    jd, td = _stacks(name)
    jr = j_agg.select_experts(jd, mode=mode, seed=3)
    tr = t_agg.select_experts(td, mode=mode, seed=3)
    np.testing.assert_array_equal(tr.drop, jr.drop)
    np.testing.assert_array_equal(tr.weights, jr.weights)
    assert (tr.num_active, tr.mode, tr.threshold, tr.clean) == (
        jr.num_active, jr.mode, jr.threshold, jr.clean)
    assert tr.renorm == jr.renorm
    if name == "duplicated":  # half the stack is the other half
        assert tr.num_dropped == (4 if mode == "drop" else 0)


def test_renorm_effective_count_and_weighted_sum():
    assert t_agg.weighted_renorm_factor(np.ones(6), 6) == 1.0
    for d in (1, 2, 5):
        w = np.r_[np.zeros(d), np.ones(6 - d)]
        assert t_agg.weighted_renorm_factor(w, 6) == renorm_factor(6, d) == 6 / (6 - d)
    with pytest.raises(ExpertQuarantineError):
        t_agg.weighted_renorm_factor(np.zeros(3), 3)
    for w in (np.ones(8), np.r_[1.0, np.zeros(7)], np.zeros(0), np.array([0.5, 0.5, 1.0])):
        assert t_agg.effective_expert_count(w) == j_agg.effective_expert_count(w)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 3)))
    assert t_agg.weighted_expert_sum(v) == torch.sum(v)
    w = np.array([0.5, 0.0, 1.0, 2.0])
    np.testing.assert_allclose(t_agg.weighted_expert_sum(v, w).item(),
                               float(j_agg.weighted_expert_sum(jnp.asarray(v.numpy()), w)),
                               rtol=1e-15)


def test_policy_lane_resolution_order(no_agg_env):
    assert t_agg.active_agg_policy() == "poe" and not t_agg.policy_engaged()
    assert t_agg.resolve_predictor_mode() == "rbcm"
    no_agg_env.setenv("GP_AGG_POLICY", "gpoe")
    assert t_agg.active_agg_policy() == "gpoe" and t_agg.resolve_predictor_mode() == "gpoe"
    assert tgp.GaussianProcessRegression(device="cpu").setAggregationPolicy("healed")
    assert t_agg.active_agg_policy() == "healed"
    with t_agg.agg_policy_scope("rbcm"):
        assert t_agg.active_agg_policy() == "rbcm"
        with t_agg.agg_policy_scope(None):
            assert t_agg.active_agg_policy() == "rbcm"
    assert t_agg.active_agg_policy() == "healed"
    assert t_agg.set_agg_policy(None) == "healed"
    assert t_agg.resolve_predictor_mode("bcm") == "bcm"
    for bad in (lambda: t_agg.set_agg_policy("mean"),
                lambda: tgp.GaussianProcessRegression(device="cpu").setAggregationPolicy("x")):
        with pytest.raises(ValueError, match="not an aggregation policy"):
            bad()
    no_agg_env.setenv("GP_AGG_SELECT_MODE", "shrink")
    with pytest.raises(ValueError, match="selection mode"):
        t_agg.selection_mode()


# -- the weights operand of the objectives ---------------------------------


def _reg_kernel(m):
    return 1.0 * m.RBFKernel(1.0, 1e-6, 10) + m.WhiteNoiseKernel(0.1, 0, 1) \
        + m.Const(1e-3) * m.EyeKernel()


@pytest.mark.parametrize("lane,bar", [("exact", 1e-10), ("iterative", 1e-8),
                                      ("matfree", 1e-8)])
def test_weighted_marginal_nll_matches_jax(solver_env, lane, bar):
    x, y = _problem()
    jk, tk = _reg_kernel(jgp), _reg_kernel(tgp)
    theta = jk.init_theta() * 0.8
    jitter = np.array([0.0, 1e-3, 0.0, 0.0, 1e-4])
    j_it.set_solver_lane(lane)
    t_it.set_solver_lane(lane)
    jd, td = j_group(x, y, 30), t_group(x, y, 30)
    j_v, j_g = j_vag(jk, jd, "marginal", (jnp.asarray(jitter), jnp.asarray(WEIGHTS)))(theta)
    t_v, t_g = t_vag(tk, td, None, "marginal", (jitter, WEIGHTS))(theta)
    assert abs(t_v - float(j_v)) <= bar * abs(float(j_v))
    assert _rel(t_g, j_g) <= bar


def test_weighted_loo_matches_jax():
    x, y = _problem()
    jk, tk = _reg_kernel(jgp), _reg_kernel(tgp)
    theta = jk.init_theta() * 0.8
    jd, td = j_group(x, y, 30), t_group(x, y, 30)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda t: j_loo.batched_loo_nll(jk, t, jd, weights=jnp.asarray(WEIGHTS))))(
        jnp.asarray(theta))
    t = torch.as_tensor(theta).requires_grad_(True)
    tv = t_loo.batched_loo_nll(tk, t, td, weights=WEIGHTS)
    (tg,) = torch.autograd.grad(tv, t)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-8
    # unit weights are the plain sum
    plain = t_loo.batched_loo_nll(tk, t, td).item()
    np.testing.assert_allclose(t_loo.batched_loo_nll(tk, t, td, weights=np.ones(5)).item(),
                               plain, rtol=1e-14)


def _cls_problem():
    """E = 5 experts of s = 30 with 0/1 labels and a count target."""
    x, y = _problem()
    labels = (y > 0).astype(np.float64)
    counts = np.random.default_rng(2).poisson(np.exp(0.5 * np.sin(x.sum(axis=1)))).astype(float)
    return x, labels, counts


def _cls_kernel(m):
    return 1.0 * m.RBFKernel(1.0) + m.Const(1e-3) * m.EyeKernel()


@pytest.mark.parametrize("family", ["laplace", "multiclass", "ep", "poisson"])
def test_weighted_laplace_families_match_jax(family):
    x, labels, counts = _cls_problem()
    jk, tk = _cls_kernel(jgp), _cls_kernel(tgp)
    theta = jk.init_theta() * 0.9
    jth, tth = jnp.asarray(theta), torch.as_tensor(theta)
    jw = jnp.asarray(WEIGHTS)
    if family == "laplace":
        jd, td = j_group(x, labels, 30), t_group(x, labels, 30)
        jv, jg, _ = jax.jit(j_lap.batched_neg_logz, static_argnums=(0, 1))(
            jk, TOL, jth, jd, jnp.zeros_like(jd.y), None, jw)
        tv, tg, _ = t_lap.batched_neg_logz(tk, TOL, tth, td, torch.zeros_like(td.y),
                                           weights=WEIGHTS)
    elif family == "multiclass":
        y3 = (np.arange(x.shape[0]) % 3).astype(np.float64)
        jd, td = j_group(x, y3, 30), t_group(x, y3, 30)
        jy, ty = j_one_hot(jd.y, jd.mask, 3), t_one_hot(td.y, td.mask, 3)
        jv, jg, _ = jax.jit(j_mc.batched_neg_logz_mc, static_argnums=(0, 1))(
            jk, TOL, jth, jd.x, jy, jd.mask, jnp.zeros_like(jy), None, jw)
        tv, tg, _ = t_mc.batched_neg_logz_mc(tk, TOL, tth, td.x, ty, td.mask,
                                             torch.zeros_like(ty), weights=WEIGHTS)
    elif family == "ep":
        jd, td = j_group(x, labels, 30), t_group(x, labels, 30)
        zeros = np.zeros(tuple(td.y.shape))
        jv, jg, _ = jax.jit(j_ep.batched_neg_logz_ep, static_argnums=(0, 1))(
            jk, TOL, jth, jd, (jnp.asarray(zeros), jnp.asarray(zeros)), jw)
        tv, tg, _ = t_ep.batched_neg_logz_ep(tk, TOL, tth, td,
                                             (torch.tensor(zeros), torch.tensor(zeros)),
                                             weights=WEIGHTS)
    else:
        jd, td = j_group(x, counts, 30), t_group(x, counts, 30)
        jv, jg, _ = jax.jit(j_lg.batched_neg_logz_generic, static_argnums=(0, 1, 2))(
            j_lg.PoissonLikelihood(), jk, TOL, jth, jd.x, jd.y, jd.mask,
            jnp.zeros_like(jd.y), None, jw)
        tv, tg, _ = t_lg.batched_neg_logz_generic(
            t_lg.PoissonLikelihood(), tk, TOL, tth, td.x, td.y, td.mask,
            torch.zeros_like(td.y), weights=WEIGHTS)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= (1e-6 if family == "multiclass" else 1e-8)


# -- fit-time selection end to end -----------------------------------------


def _estimator(m, **kw):
    return (m.GaussianProcessRegression(**kw).setKernel(lambda: m.RBFKernel(1.0))
            .setDatasetSizeForExpert(40).setActiveSetSize(30).setSigma2(1e-3)
            .setMaxIter(5).setSeed(7))


@pytest.mark.parametrize("mode", ["drop", "downweight"])
def test_selection_fit_matches_jax(mode, no_agg_env):
    x, y = _duplicated(base_n=160)  # E = 8, experts 2j and 2j + 1 identical
    no_agg_env.setenv("GP_AGG_SELECT", "1")
    no_agg_env.setenv("GP_AGG_SELECT_MODE", mode)
    jm = _estimator(jgp).fit(x, y)
    tm = _estimator(tgp, device="cpu").fit(x, y)
    for key in ("agg.selection_dropped", "agg.renorm", "agg.effective_experts", "agg.policy"):
        assert tm.metrics[key] == jm.instr.metrics[key], key
    assert tm.metrics["agg.selection_dropped"] == (4.0 if mode == "drop" else 0.0)
    assert tm.metrics["agg.renorm"] == 2.0
    np.testing.assert_allclose(tm.metrics["final_nll_renormalized"],
                               jm.instr.metrics["final_nll_renormalized"], rtol=1e-6)
    np.testing.assert_allclose(tm.raw_predictor.theta, jm.raw_predictor.theta, rtol=1e-5)
    xt = x[:30] + 0.1
    np.testing.assert_allclose(tm.predict(xt), jm.predict(xt), rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(jm.predict(xt))))
