"""The port's native multiclass classifier (``models/laplace_mc.py``,
``models/gpc_mc.py``) and the iterative lane's factored solvers against
the JAX package's, float64 on the CPU, on the same seeded inputs: three
Gaussian blobs, 24 points, grouped into E = 2 experts of s = 12, with the
estimator's own kernel ``RBF + 1e-3 I`` and its gram cache.  Bars: the
mode and ``-log Z`` within 1e-8, the gradient within 1e-6 (relative to
its largest component) and against central differences (1e-6); K1's
branch (through its plain version) against the Cholesky branch and its
call count; padding; ``factored_solve`` and its gradient against a
dense solve (1e-9), ``factored_logdet`` against the dense log-det
within 1% at 32768 probes; the iterative lane with the JAX probes
injected (tests/_torch_solver_helpers.py); the fitted estimator's theta
(1e-5) and probabilities (1e-6, averaged too); a JAX model carried
across (1e-10); label validation."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_solver_helpers import solver_env  # noqa: F401  (fixture)

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.kernels.base import prepare_gram_cache as j_prepare
from spark_gp_tpu.models import laplace_mc as j_mc
from spark_gp_tpu.models.gpc_mc import _one_hot_masked as j_one_hot
from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu.parallel.experts import group_for_experts as j_group
from spark_gp_tpu_torch.convert import FIELDS, multiclass_from_fields
from spark_gp_tpu_torch.kernels.base import prepare_gram_cache as t_prepare
from spark_gp_tpu_torch.models import laplace_mc as t_mc
from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked as t_one_hot
from spark_gp_tpu_torch.ops import iterative as t_it
from spark_gp_tpu_torch.ops import spd_linalg
from spark_gp_tpu_torch.parallel.experts import group_for_experts as t_group

TOL = 1e-6  # the estimator's default, so the JAX programs compile once
C = 3
J_MODE = jax.jit(j_mc.laplace_mc_mode, static_argnums=4)


def _blobs(n=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 2.0]])
    y = np.arange(n) % C
    return centers[y] + 0.9 * rng.normal(size=(n, 2)), y.astype(np.float64)


def _kernel(m):
    return m.RBFKernel() + m.Const(1e-3) * m.EyeKernel()


def _stacks(x, y, expert=12):
    """``(kernel, x, y1h, mask, cache)`` of each package on the same stack."""
    jk, tk = _kernel(jgp), _kernel(tgp)
    jd, td = j_group(x, y, expert), t_group(x, y, expert, dtype=torch.float64)
    return (
        (jk, jd.x, j_one_hot(jd.y, jd.mask, C), jd.mask, j_prepare(jk, jd.x)),
        (tk, td.x, t_one_hot(td.y, td.mask, C), td.mask, t_prepare(tk, td.x)),
    )


def _rel(a, b):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


def _t_neg_logz(t, theta, tol=TOL, f0=None):
    tk, x, y1h, mask, cache = t
    f0 = torch.zeros_like(y1h) if f0 is None else f0
    return t_mc.batched_neg_logz_mc(tk, tol, torch.as_tensor(theta), x, y1h, mask, f0, cache)


@pytest.mark.parametrize("scale", [1.0, 0.6])
def test_neg_logz_and_mode_match_jax(scale):
    x, y = _blobs()
    j, t = _stacks(x, y)
    theta = np.array([scale])
    jv, jg, jf = j_mc._mc_vag_impl(j[0], TOL, jnp.asarray(theta), *j[1:4],
                                   jnp.zeros_like(j[2]), j[4], solver=j_it.solver_jit_key())
    tv, tg, tf = _t_neg_logz(t, theta)
    assert tuple(tf.shape) == (2, 12, C)
    assert _rel(tf.numpy(), jf) <= 1e-8
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-6
    # the Newton loop alone: the same modes and objectives
    kmat = np.array(j_mc._gram_stack(j[0], jnp.asarray(theta), j[1], j[3], j[4]))
    jm, jo = J_MODE(jnp.asarray(kmat), j[2], j[3], jnp.zeros_like(j[2]), TOL)
    tm, to = t_mc.laplace_mc_mode(torch.as_tensor(kmat), t[2], t[3], torch.zeros_like(t[2]),
                                  TOL)
    assert _rel(tm.numpy(), jm) <= 1e-8
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-8)


def test_gradient_matches_central_differences():
    x, y = _blobs()
    _, t = _stacks(x, y)
    theta = np.array([0.8])
    _, grad, _ = _t_neg_logz(t, theta, tol=1e-12)
    h = 1e-6
    up = _t_neg_logz(t, theta + h, tol=1e-12)[0].item()
    down = _t_neg_logz(t, theta - h, tol=1e-12)[0].item()
    np.testing.assert_allclose(grad.numpy(), [(up - down) / (2 * h)], rtol=1e-6)


def test_padded_rows_are_inert():
    """Three padded slots an expert (copies of its first row, mask 0)
    leave the value, the gradient and the real rows' modes as they were,
    and their own modes at 0: the double-where sqrt guard keeps the
    gradient finite where the softmax is exactly 0."""
    x, y = _blobs()
    _, (tk, tx, ty, tm, _) = _stacks(x, y)
    pad = 3
    xp = torch.cat([tx, tx[:, :1].expand(2, pad, 2)], dim=1)
    yp = torch.cat([ty, torch.zeros(2, pad, C, dtype=ty.dtype)], dim=1)
    mp = torch.cat([tm, torch.zeros(2, pad, dtype=tm.dtype)], dim=1)
    v, g, f = _t_neg_logz((tk, tx, ty, tm, None), np.array([0.8]), tol=1e-10)
    vp, gp, fp = _t_neg_logz((tk, xp, yp, mp, t_prepare(tk, xp)), np.array([0.8]), tol=1e-10)
    assert torch.isfinite(gp).all()
    np.testing.assert_allclose(vp.item(), v.item(), rtol=1e-12)
    np.testing.assert_allclose(gp.numpy(), g.numpy(), rtol=1e-10)
    np.testing.assert_allclose(fp[:, :12].numpy(), f.numpy(), atol=1e-10)
    assert torch.all(fp[:, 12:] == 0)


def test_k1_branch_matches_cholesky_branch_and_counts(monkeypatch):
    """The card's branch (K1's ``B_c^-1`` and ``log|B_c|`` over the whole
    ``[E * C, s, s]`` stack) forced on the CPU, where the wrapper runs
    K1's plain version, against the Cholesky branch; K1 runs once a
    Newton iteration and twice an evaluation."""
    x, y = _blobs()
    _, t = _stacks(x, y)
    theta = np.array([0.8])
    v_chol, g_chol, f_chol = _t_neg_logz(t, theta, tol=1e-10)
    calls = []

    def counted(k):
        calls.append(tuple(k.shape))
        return spd_linalg.spd_inv_logdet_plain(k)

    monkeypatch.setattr(spd_linalg, "kernel_applies", lambda k: True)
    monkeypatch.setattr(spd_linalg, "spd_inv_logdet", counted)
    before = (t_mc.laplace_mc_mode.iterations, t_mc.batched_neg_logz_mc.calls)
    v_inv, g_inv, f_inv = _t_neg_logz(t, theta, tol=1e-10)
    iterations = t_mc.laplace_mc_mode.iterations - before[0]
    assert t_mc.batched_neg_logz_mc.calls - before[1] == 1
    np.testing.assert_allclose(v_inv.item(), v_chol.item(), rtol=1e-10)
    np.testing.assert_allclose(g_inv.numpy(), g_chol.numpy(), rtol=1e-8)
    np.testing.assert_allclose(f_inv.numpy(), f_chol.numpy(), atol=1e-11)
    assert len(calls) == iterations + 2 and iterations > 1
    assert set(calls) == {(2 * C, 12, 12)}


@pytest.mark.cuda
def test_k1_launches_on_card():
    """On the card (float32) K1 runs once a Newton iteration and twice an
    evaluation, and the objective agrees with the CPU's float64 one at the
    classifier's bars (1e-4 value, 1e-3 gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, y = _blobs()
    _, (tk, tx, ty, tm, cache) = _stacks(x, y)
    card = [a.float().cuda() for a in (tx, ty, tm, *cache)]
    theta = np.array([0.8])
    before = (spd_linalg.spd_inv_logdet.launches, t_mc.laplace_mc_mode.iterations)
    v32, g32, _ = t_mc.make_mc_objective(tk, *card[:3], 1e-3, tuple(card[3:]))(
        theta, torch.zeros_like(card[1]))
    launches = spd_linalg.spd_inv_logdet.launches - before[0]
    assert launches == t_mc.laplace_mc_mode.iterations - before[1] + 2
    v64, g64, _ = t_mc.make_mc_objective(tk, tx, ty, tm, 1e-3, cache)(
        theta, torch.zeros_like(ty))
    np.testing.assert_allclose(v32, v64, rtol=1e-4)
    assert _rel(g32, g64) <= 1e-3


# --- the iterative lane's factored solvers -------------------------------


def _factored_system(seed=5, e=2, s=12):
    """An RBF gram stack ``K(sigma)`` and the softmax root ``S`` of a random
    latent draw, as in the Newton step."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(e, s, 2)))
    sq = torch.sum((x[:, :, None] - x[:, None]) ** 2, dim=-1)
    pi = torch.softmax(torch.as_tensor(rng.normal(size=(e, s, C))), dim=-1)
    sqd = torch.sqrt(pi)
    smat = sqd[..., :, None] * torch.eye(C, dtype=pi.dtype) - pi[..., :, None] * sqd[..., None, :]
    return (lambda sigma: torch.exp(-sq / (2 * sigma * sigma))), smat


def _dense_factored(kmat, smat):
    """``I + S^T K_blk S`` as ``[E, sC, sC]`` (row index ``s * C + c``)."""
    e, s, c = smat.shape[:3]
    kblk = torch.stack([torch.kron(k, torch.eye(c, dtype=k.dtype)) for k in kmat])
    sblk = torch.stack([torch.block_diag(*m) for m in smat])
    return torch.eye(s * c, dtype=kmat.dtype) + sblk.mT @ kblk @ sblk


def test_factored_solve_and_gradient_match_dense(monkeypatch):
    monkeypatch.setenv("GP_SOLVER_CG_TOL", "1e-12")
    kfn, smat = _factored_system()
    e, s = smat.shape[:2]
    rng = np.random.default_rng(6)
    b = torch.as_tensor(rng.normal(size=(e, s, C)))
    weight = torch.as_tensor(rng.normal(size=(e, s, C)))
    grads = []
    for solve in ("factored", "dense"):
        sigma = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
        sm = smat.clone().requires_grad_(True)
        bb = b.clone().requires_grad_(True)
        if solve == "factored":
            x = t_it.factored_solve(kfn(sigma), sm, bb)
        else:
            x = torch.linalg.solve(_dense_factored(kfn(sigma), sm),
                                   bb.reshape(e, s * C)).reshape(e, s, C)
        grads.append((x.detach(), *torch.autograd.grad(torch.sum(weight * x),
                                                       (sigma, sm, bb))))
    for got, want in zip(*grads):
        assert _rel(got.numpy(), want.numpy()) <= 1e-9


def test_factored_logdet_and_gradient_match_dense(monkeypatch):
    """SLQ within 1% of the dense log-det at 32768 probes; the surrogate's
    gradient within 1% of the dense log-det's central difference."""
    monkeypatch.setenv("GP_SOLVER_PROBES", "32768")
    kfn, smat = _factored_system(seed=7)

    def dense(sigma):
        return torch.linalg.slogdet(_dense_factored(kfn(sigma), smat))[1]

    sigma = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    got = t_it.factored_logdet(kfn(sigma), smat)
    np.testing.assert_allclose(got.detach().numpy(), dense(sigma).detach().numpy(), rtol=1e-2)
    (grad,) = torch.autograd.grad(torch.sum(got), sigma)
    h = 1e-5
    with torch.no_grad():
        fd = (torch.sum(dense(sigma + h)) - torch.sum(dense(sigma - h))) / (2 * h)
    np.testing.assert_allclose(grad.item(), fd.item(), rtol=1e-2)


@pytest.mark.parametrize("lane", ["iterative", "matfree"])
def test_iterative_lane_matches_jax(solver_env, lane):
    """The factored CG Newton step and the SLQ log-det, both packages on
    the same probes (matfree resolves to the same materialized solves)."""
    x, y = _blobs()
    j, t = _stacks(x, y)
    j_it.set_solver_lane(lane)
    t_it.set_solver_lane(lane)
    theta = np.array([0.8])
    jv, jg, jf = j_mc._mc_vag_impl(j[0], TOL, jnp.asarray(theta), *j[1:4],
                                   jnp.zeros_like(j[2]), j[4], solver="iterative")
    tv, tg, tf = _t_neg_logz(t, theta)
    assert _rel(tf.numpy(), jf) <= 1e-8
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    assert _rel(tg.numpy(), jg) <= 1e-6


# --- the estimator --------------------------------------------------------


def _gpc(m, **kw):
    gp = m.GaussianProcessMulticlassClassifier(**kw).setDatasetSizeForExpert(12) \
        .setActiveSetSize(10)
    return gp.setOptimizer("host") if m is jgp else gp


@pytest.fixture(scope="module")
def blob_fits():
    x, y = _blobs()
    xt = _blobs(30, seed=1)[0]
    return x, y, xt, _gpc(jgp).fit(x, y), _gpc(tgp, device="cpu").fit(x, y)


def test_estimator_matches_jax(blob_fits):
    x, y, xt, j_model, t_model = blob_fits
    np.testing.assert_allclose(t_model.raw_predictor.theta, j_model.raw_predictor.theta,
                               rtol=1e-5)
    np.testing.assert_array_equal(t_model.raw_predictor.active, j_model.raw_predictor.active)
    assert t_model.num_classes == j_model.num_classes == C
    for averaged in (False, True):
        got = t_model.predict_proba(xt, averaged=averaged)
        np.testing.assert_allclose(got, j_model.predict_proba(xt, averaged=averaged),
                                   atol=1e-6)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(t_model.predict(xt), j_model.predict(xt))
    accuracy = np.mean(t_model.predict(x) == y)
    assert accuracy == np.mean(j_model.predict(x) == y) and accuracy > 0.8
    m = t_model.metrics
    assert (m["num_experts"], m["expert_size"], m["num_classes"]) == (2, 12, C)
    assert (m["solver_lane"], m["gram_cache_engaged"]) == ("exact", 1.0)
    # each evaluation runs its Newton loop; one more settles the modes
    assert m["objective_calls"] == m["lbfgs_nfev"] + 1
    assert m["newton_iterations"] >= m["objective_calls"]


def test_multiclass_from_fields_carries_a_jax_model(blob_fits):
    _, _, xt, j_model, _ = blob_fits
    raw = j_model.raw_predictor
    fields = {name: getattr(raw, name, None) for name in FIELDS}
    fields = {k: None if v is None else np.asarray(v) for k, v in fields.items()}
    model = multiclass_from_fields(fields, _kernel(tgp), device="cpu")
    np.testing.assert_allclose(model.predict_raw(xt), j_model.predict_raw(xt), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(model.predict_proba(xt, averaged=True, seed=3),
                               j_model.predict_proba(xt, averaged=True, seed=3),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match=r"\[m, C\]"):
        multiclass_from_fields({**fields, "magic_vector": fields["magic_vector"][:, 0]},
                               _kernel(tgp))


@pytest.mark.parametrize("labels,match", [
    ([0, 1, 2.5], "integers"),
    ([0, -1, 1], "integers"),
    ([0, 0, 0], "at least 2 classes"),
    ([0, 1, np.nan], "integers"),  # the JAX package's message
], ids=["fraction", "negative", "one_class", "nan"])
def test_label_validation(labels, match):
    x = np.random.default_rng(0).normal(size=(24, 2))
    y = np.resize(np.asarray(labels, dtype=np.float64), 24)
    with pytest.raises(ValueError, match=match):
        _gpc(tgp, device="cpu").fit(x, y)


def test_estimator_surface(tmp_path):
    x, y = _blobs()
    gp = _gpc(tgp, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        gp.fit(x[:, 0], y)
    with pytest.raises(NotImplementedError, match="item 6"):
        gp.fit_distributed(None)
    model = gp.setPredictiveVariance(False).setMaxIter(2).fit(x, y)
    assert model.predict_proba(x[:4]).shape == (4, C)
    # model I/O is ported (test_torch_serialization.py)
    model.save(str(tmp_path / "m.npz"))
    loaded = tgp.GaussianProcessMulticlassModel.load(str(tmp_path / "m.npz"), device="cpu")
    np.testing.assert_array_equal(loaded.predict_raw(x[:4]), model.predict_raw(x[:4]))
    with pytest.raises(ValueError, match="setPredictiveVariance"):
        model.predict_proba(x[:4], averaged=True)
