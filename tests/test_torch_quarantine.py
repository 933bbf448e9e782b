"""The port's recovery layer (``resilience/``, ``ops/linalg.py``'s jitter
ladder, ``ExpertData.with_experts_masked`` and the estimators' data
screen and recovery loop) against the JAX package's, float64 on the
CPU.  Bars: the ladder's rung exactly and its factor within 1e-10 of its
largest entry (a rank-deficient matrix's factor is fixed only to about
eps * kappa in its small entries, ~1e-5 relative at kappa ~ 1e10); the
health probe's NLL and gradient norm within 1e-10; ``diagnose_experts``
the same ``bad`` and ``jitter``; a regression fit with a ``nan``, ``inf``
or ``dup`` poisoned expert the same quarantined set, ``bcm_renorm`` and
jittered count, theta at rtol 1e-5 and predictions at rtol 1e-6 (the
regression fit test's bars; at zero noise, ``dup``, the variance
cancels to ~1e-9 near the training points and is held to 1e-5 of the
prior variance there); a classifier fit with a poisoned row the same
quarantine, theta at rtol 1e-5 and probabilities within 1e-6."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.ops.linalg import cholesky_escalated as j_escalated
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu.parallel.experts import num_experts_for
from spark_gp_tpu.resilience import chaos
from spark_gp_tpu.resilience import quarantine as j_q
from spark_gp_tpu_torch.models.likelihood import batched_nll
from spark_gp_tpu_torch.ops.linalg import (
    NotPositiveDefiniteException,
    cholesky_escalated,
    is_pd,
)
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group
from spark_gp_tpu_torch.resilience import (
    ExpertQuarantineError,
    NonFiniteFitError,
    RetryBudgetExceededError,
    diagnose_experts,
    expert_health,
    nonfinite_expert_mask,
    quarantine_experts,
    retry_with_backoff,
)


def _spd(n, rng, floor=1.0):
    a = rng.normal(size=(n, n))
    return a @ a.T + floor * np.eye(n)


# -- the jitter ladder ------------------------------------------------------


def _ladder_cases():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(10, 4))
    b = rng.normal(size=(6, 2))
    return {
        "pd": _spd(12, rng),
        "rank4": a @ a.T,
        "batch": np.stack([_spd(6, rng), b @ b.T, _spd(6, rng, 1e-3)]),
    }


@pytest.mark.parametrize("case", ["pd", "rank4", "batch"])
def test_jitter_ladder_matches_jax(case):
    mat = _ladder_cases()[case]
    j_chol, j_tau = j_escalated(jnp.asarray(mat))
    t_chol, t_tau = cholesky_escalated(torch.as_tensor(mat))
    assert t_tau == j_tau and (t_tau == 0.0) == (case == "pd")
    assert is_pd(t_chol)
    j_chol = np.asarray(j_chol)
    assert np.max(np.abs(t_chol.numpy() - j_chol)) <= 1e-10 * np.max(np.abs(j_chol))
    if case == "batch":  # the healthy matrices keep their unjittered factors
        for i in (0, 2):
            np.testing.assert_allclose(t_chol[i].numpy(), np.linalg.cholesky(mat[i]), rtol=1e-10)


@pytest.mark.parametrize("bad", ["indefinite", "nan"])
def test_jitter_ladder_exhausts(bad):
    mat = np.diag([1.0, -1e6]) if bad == "indefinite" else np.full((3, 3), np.nan)
    with pytest.raises(NotPositiveDefiniteException):
        cholesky_escalated(torch.as_tensor(mat))


# -- screen, probe, diagnosis, quarantine ----------------------------------


def _rows(n=120, poison=None, kind="nan", seed=0):
    """120 rows in 3-d at expert size 30: E = 4; ``poison`` corrupts every
    row of that expert: NaN features, NaN / inf labels, or one repeated
    row (a singular gram at zero noise)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = np.sin(x.sum(axis=1))
    if poison is not None:
        rows = np.arange(poison, n, 4)
        if kind == "labels":
            y[rows[::2]] = np.inf
            y[rows[1::2]] = np.nan
        elif kind == "dup":
            x[rows] = x[rows[0]]
            y[rows] = y[rows[0]]
        else:
            x[rows, 0] = np.nan
    return x, y


def _model_kernel(m, sigma2=1e-3):
    return m.GaussianProcessRegression().setKernel(lambda: m.RBFKernel(1.0)) \
        .setSigma2(sigma2)._get_kernel()


@pytest.mark.parametrize("kind,sigma2,bad,jittered", [
    ("clean", 1e-3, [], 0), ("nan", 1e-3, [2], 0), ("labels", 1e-3, [1], 0),
    ("dup", 0.0, [], 1),
])
def test_probe_and_diagnosis_match_jax(kind, sigma2, bad, jittered):
    poison = None if kind == "clean" else (1 if kind in ("labels", "dup") else 2)
    x, y = _rows(poison=poison, kind=kind)
    jd, td = j_group(x, y, 30), t_group(x, y, 30)
    jk, tk = _model_kernel(jgp, sigma2), _model_kernel(tgp, sigma2)
    theta = jk.init_theta()
    np.testing.assert_array_equal(nonfinite_expert_mask(td), j_q.nonfinite_expert_mask(jd))
    j_nll, j_g = j_q.expert_health(jk, theta, jd)
    t_nll, t_g = expert_health(tk, theta, td)
    np.testing.assert_array_equal(np.isfinite(t_nll), np.isfinite(j_nll))
    ok = np.isfinite(j_nll)
    np.testing.assert_allclose(t_nll[ok], j_nll[ok], rtol=1e-10)
    np.testing.assert_allclose(t_g[ok], j_g[ok], rtol=1e-10)
    jr, tr = j_q.diagnose_experts(jk, theta, jd), diagnose_experts(tk, theta, td)
    np.testing.assert_array_equal(tr.bad, jr.bad)
    np.testing.assert_array_equal(tr.jitter, jr.jitter)
    assert np.flatnonzero(tr.bad).tolist() == bad and tr.num_jittered == jittered
    assert tr.renorm == jr.renorm and tr.clean == (kind == "clean")
    if bad:
        # the reduced sum is the healthy experts' sum; no NaN or inf leaks
        clean = quarantine_experts(td, tr.bad)
        assert float(clean.mask[bad[0]].sum()) == 0.0
        assert bool(torch.isfinite(clean.x).all() and torch.isfinite(clean.y).all())
        total = batched_nll(tk, torch.as_tensor(theta), clean).item()
        np.testing.assert_allclose(total, np.delete(t_nll, bad).sum(), rtol=1e-12)
    else:
        assert quarantine_experts(td, tr.bad) is td
    with pytest.raises(ExpertQuarantineError, match="every expert"):
        quarantine_experts(td, np.ones(4, dtype=bool))


def test_with_experts_masked_matches_jax():
    x, y = _rows(poison=3, kind="labels")
    drop = np.array([False, True, False, True])
    jm = j_group(x, y, 30).with_experts_masked(drop)
    tm = t_group(x, y, 30).with_experts_masked(drop)
    for field in ("x", "y", "mask"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jm, field)))


# -- retry ----------------------------------------------------------------


def test_retry_with_backoff():
    calls, delays, repaired = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("boom")
        return "done"

    out = retry_with_backoff(flaky, attempts=3, base_delay_s=0.01, retry_on=(ValueError,),
                             on_retry=lambda i, exc: repaired.append((i, str(exc))),
                             sleep=delays.append)
    assert out == "done" and len(calls) == 3
    assert repaired == [(0, "boom"), (1, "boom")] and delays == [0.01, 0.02]

    def always():
        raise ValueError("persistent")

    with pytest.raises(RetryBudgetExceededError) as err:
        retry_with_backoff(always, attempts=2, retry_on=(ValueError,), sleep=lambda _: None)
    assert isinstance(err.value.__cause__, ValueError)
    with pytest.raises(KeyError):
        retry_with_backoff(lambda: {}["x"], attempts=3, retry_on=(ValueError,))
    with pytest.raises(ValueError, match="attempts"):
        retry_with_backoff(flaky, attempts=0)


# -- the estimators end to end ---------------------------------------------


def _gp(m, **kw):
    return (m.GaussianProcessRegression(**kw).setKernel(lambda: m.RBFKernel(1.0))
            .setDatasetSizeForExpert(40).setActiveSetSize(50).setMaxIter(15).setSeed(3))


METRICS = ("experts_active_initial", "experts_quarantined", "bcm_renorm", "experts_jittered",
           "fit_retries", "agg.effective_experts", "agg.policy")


@pytest.mark.parametrize("kind", ["nan", "inf", "dup"])
def test_poisoned_regression_fit_matches_jax(kind):
    """nan and inf: the data screen quarantines the expert; dup (at zero
    noise): the first evaluation fails, the probe repairs the expert by
    a jitter rung, and the retry succeeds."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(240, 3))
    y = np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=240)
    xp, yp = chaos.poison_expert(x, y, expert=1, num_experts=num_experts_for(240, 40),
                                 kind=kind, seed=1)
    sigma2 = 0.0 if kind == "dup" else 1e-3
    jm = _gp(jgp).setSigma2(sigma2).fit(xp, yp)
    tm = _gp(tgp, device="cpu").setSigma2(sigma2).fit(xp, yp)
    for key in METRICS:
        assert tm.metrics.get(key) == jm.instr.metrics.get(key), key
    if kind == "dup":
        assert tm.metrics["experts_jittered"] == 1 and "experts_quarantined" not in tm.metrics
    else:
        assert tm.metrics["experts_quarantined"] == 1.0 and tm.metrics["bcm_renorm"] == 1.2
        np.testing.assert_allclose(tm.metrics["final_nll_renormalized"],
                                   tm.metrics["final_nll"] * 1.2, rtol=1e-15)
    np.testing.assert_allclose(tm.raw_predictor.theta, jm.raw_predictor.theta, rtol=1e-5)
    j_mean, j_var = jm.predict_with_var(x[:30])
    t_mean, t_var = tm.predict_with_var(x[:30])
    np.testing.assert_allclose(t_mean, j_mean, rtol=1e-6, atol=1e-6 * np.max(np.abs(j_mean)))
    # the prior variance is 1 (RBF, no amplitude)
    np.testing.assert_allclose(t_var, j_var, rtol=1e-6, atol=1e-5 if kind == "dup" else 0.0)


def test_quarantine_off_and_all_bad_raise():
    """Without quarantine a poisoned expert fails the fit as in the JAX
    package (the first evaluation is not finite); with it, a stack whose
    every expert is poisoned is refused; with no retries the failure is
    final."""
    x, y = _rows(n=80, poison=1)
    with pytest.raises(NotPositiveDefiniteException):
        _gp(tgp, device="cpu").setExpertQuarantine(False).fit(x, y)
    x_all = x.copy()
    x_all[:, 1] = np.nan
    with pytest.raises(ExpertQuarantineError, match="all 2 active"):
        _gp(tgp, device="cpu").fit(x_all, y)
    xd, yd = _rows(n=80, poison=1, kind="dup")
    with pytest.raises(NotPositiveDefiniteException):
        _gp(tgp, device="cpu").setSigma2(0.0).setDatasetSizeForExpert(20).setFitRetries(0).fit(
            xd, yd)
    assert issubclass(NonFiniteFitError, RuntimeError)
    assert tgp.NonFiniteFitError is NonFiniteFitError
    assert tgp.ExpertQuarantineError is ExpertQuarantineError


def test_poisoned_classifier_fit_matches_jax():
    """One NaN feature row: the screen drops its expert, and the provider
    sees only the finite rows and their latent targets."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(90, 2))
    y = (x[:, 0] + 0.3 * rng.normal(size=90) > 0).astype(np.float64)
    x[4, 1] = np.nan  # expert 4 % 3 = 1

    def gp(m, **kw):
        return (m.GaussianProcessClassifier(**kw).setKernel(lambda: m.RBFKernel(1.0))
                .setDatasetSizeForExpert(30).setActiveSetSize(20).setMaxIter(10).setSeed(2))

    jm, tm = gp(jgp).fit(x, y), gp(tgp, device="cpu").fit(x, y)
    for key in METRICS:
        assert tm.metrics.get(key) == jm.instr.metrics.get(key), key
    assert tm.metrics["experts_quarantined"] == 1.0 and tm.metrics["bcm_renorm"] == 1.5
    np.testing.assert_allclose(tm.raw_predictor.theta, jm.raw_predictor.theta, rtol=1e-5)
    np.testing.assert_array_equal(tm.raw_predictor.active, jm.raw_predictor.active)
    xt = np.delete(x, 4, axis=0)[:20]
    np.testing.assert_allclose(tm.predict_proba(xt), jm.predict_proba(xt), atol=1e-6)
