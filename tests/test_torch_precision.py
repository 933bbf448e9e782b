"""The precision lanes of the port (``ops/precision.py``, ``ops/distance.py``,
``ops/lane_gram.py``) against the JAX package's (its
``tests/test_precision_policy.py``), float32 on the CPU, where the lane
kernel's plain version runs (TF32 rounding on the bit pattern, float32
matmuls):

* every kernel family's gram at the mixed and fast lanes against the JAX
  package's at the same lane, over max |gram|: 1e-5 mixed, 5e-2 fast (the
  JAX package's own bars against strict); the fast lane does differ from
  strict (the lane is engaged);
* near-coincident points (distances ~1e-5 on |x|^2 ~ 10) at mixed within
  1e-5 of strict's scale, clamped non-negative;
* float64 operands bit-equal on every lane;
* the lane's plain version: TF32 rounding against a numpy reference, the
  split exact to the dropped term, the gradient against float64 autograd
  of the strict distances (5e-6 of its largest entry);
* the guard's objective probe at mixed against the JAX package's (float32,
  1e-5 relative) and a CPU fit at mixed stamping the guard's metrics;
* the guard's deltas on an ill-conditioned probe (sigma2 1e-4) by the
  port's route (the lane's gram, float64 algebra), by a float32 route
  through K1's plain version, and by the JAX package's guard: each
  recorded, the same verdict on every route;
* the env / setter / scope round trip and its error messages, a
  ``GP_MATMUL_PRECISION`` pin below ``highest`` refused; the fluent
  estimator setter; the serve batcher's predict unmoved by the lane;
* no write of ``allow_tf32`` outside ``ops/precision.py``;
* on a card (``cuda`` marker): the kernel against its plain version.
"""

import ast
import os
from pathlib import Path

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models.likelihood import guard_probe_value_and_grad as j_probe
from spark_gp_tpu.ops import precision as j_precision
from spark_gp_tpu_torch.models.likelihood import guard_probe_value_and_grad as t_probe
from spark_gp_tpu_torch.ops import lane_gram as lg
from spark_gp_tpu_torch.ops import precision
from spark_gp_tpu_torch.ops.distance import mxu_inner, sq_dist, sq_dist_self, weighted_sq_dist
from spark_gp_tpu_torch.ops.precision import (
    LANES,
    active_lane,
    get_policy,
    precision_lane_scope,
    set_precision_lane,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_lane(monkeypatch):
    for name in ("GP_PRECISION_LANE", "GP_PRECISION_GRAM", "GP_MATMUL_PRECISION"):
        monkeypatch.delenv(name, raising=False)
    set_precision_lane(None)
    j_precision.set_precision_lane(None)
    yield
    set_precision_lane(None)
    j_precision.set_precision_lane(None)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _families(m):
    return {
        "rbf": lambda: m.RBFKernel(0.4),
        "ard_rbf": lambda: m.ARDRBFKernel(np.array([0.3, 0.6, 1.1])),
        "matern12": lambda: m.Matern12Kernel(0.8),
        "matern32": lambda: m.Matern32Kernel(0.8),
        "matern52": lambda: m.Matern52Kernel(0.8),
        "rq": lambda: m.RationalQuadraticKernel(0.8, 1.7),
        "periodic": lambda: m.PeriodicKernel(1.3, 0.6),
        "dot": lambda: m.DotProductKernel(0.7),
        "poly": lambda: m.PolynomialKernel(3, 1.2),
        "spectral_mixture": lambda: m.SpectralMixtureKernel(3, q=2),
        "composite": lambda: 1.0 * m.RBFKernel(0.4) + m.WhiteNoiseKernel(0.5, 0, 1),
    }


FAMILIES = sorted(_families(tgp))
_LANE_RTOL = {"mixed": 1e-5, "fast": 5e-2}


def _port_gram(kernel, theta, x, lane):
    with precision_lane_scope(lane):
        return kernel.gram(torch.as_tensor(theta, dtype=torch.float32),
                           torch.as_tensor(x)).double().numpy()


def _jax_gram(kernel, theta, x, lane):
    j_precision.set_precision_lane(lane)
    try:
        return np.asarray(kernel.gram(jnp.asarray(theta, dtype=jnp.float32),
                                      jnp.asarray(x)), dtype=np.float64)
    finally:
        j_precision.set_precision_lane(None)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("lane", ["mixed", "fast"])
def test_gram_parity_with_jax_at_each_lane(family, lane, rng):
    kernel_t, kernel_j = _families(tgp)[family](), _families(jgp)[family]()
    theta = np.asarray(kernel_j.init_theta(), dtype=np.float32)
    x = rng.normal(size=(48, 3)).astype(np.float32)
    k_t = _port_gram(kernel_t, theta, x, lane)
    k_j = _jax_gram(kernel_j, theta, x, lane)
    scale = np.max(np.abs(k_j))
    assert np.max(np.abs(k_t - k_j)) / scale <= _LANE_RTOL[lane]


def test_the_fast_lane_is_engaged(rng):
    kernel = tgp.RBFKernel(0.4)
    theta = kernel.init_theta()
    x = rng.normal(size=(48, 3)).astype(np.float32)
    strict, fast = (_port_gram(kernel, theta, x, lane) for lane in ("strict", "fast"))
    assert 1e-6 < np.max(np.abs(fast - strict)) <= 5e-2


def test_compensated_sq_dist_small_distances(rng):
    base = rng.normal(size=(32, 4)).astype(np.float32)
    x = torch.as_tensor(np.concatenate([base, base + 1e-3 * rng.normal(size=base.shape)])
                        .astype(np.float32))
    w = torch.tensor([1.0, 0.5, 2.0, 1.5])
    d_strict, dw_strict = sq_dist(x, x).double(), weighted_sq_dist(x, x, w).double()
    with precision_lane_scope("mixed"):
        d_mixed, dw_mixed = sq_dist(x, x).double(), weighted_sq_dist(x, x, w).double()
    assert float((d_mixed - d_strict).abs().max() / d_strict.max()) < 1e-5
    assert float((dw_mixed - dw_strict).abs().max() / dw_strict.max()) < 1e-5
    assert float(d_mixed.min()) >= 0.0
    # the JAX package's mixed lane on the same points
    j_precision.set_precision_lane("mixed")
    try:
        from spark_gp_tpu.ops.distance import sq_dist as j_sq_dist

        d_jax = np.asarray(j_sq_dist(jnp.asarray(x.numpy()), jnp.asarray(x.numpy())))
    finally:
        j_precision.set_precision_lane(None)
    assert float(np.abs(d_mixed.numpy() - d_jax).max() / d_jax.max()) < 1e-5


def test_f64_inputs_are_lane_immune(rng):
    x64 = torch.as_tensor(rng.normal(size=(24, 3)))
    outs = {}
    for lane in LANES:
        with precision_lane_scope(lane):
            outs[lane] = (mxu_inner(x64, x64), sq_dist(x64, x64), sq_dist_self(x64))
    for lane in ("mixed", "fast"):
        for a, b in zip(outs["strict"], outs[lane]):
            assert torch.equal(a, b)


def test_tf32_rounding_and_split(rng):
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, size=4096)).astype(np.float32)
    x[:3] = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12]  # ties, and above
    bits = x.view(np.uint32)
    ref = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    hi, lo = lg.split_tf32(torch.as_tensor(x))
    assert np.array_equal(hi.numpy(), ref)
    assert hi[0] == 1.0 + 2.0 ** -10 and hi[1] == -(1.0 + 2.0 ** -10)  # ties away from zero
    assert np.all((hi.numpy().view(np.uint32) & 0x1FFF) == 0)
    assert np.all((lo.numpy().view(np.uint32) & 0x1FFF) == 0)
    # hi + lo recovers x to the dropped residual, 2^-22 of |x|
    err = np.abs((hi + lo).double().numpy() - x.astype(np.float64))
    assert np.all(err <= 2.0 ** -21 * np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
@pytest.mark.parametrize("kind", ["distances", "self", "inner"])
def test_lane_gram_gradient_is_the_ieee_contraction(mode, kind, rng):
    x1 = torch.tensor(rng.normal(size=(2, 20, 4)), dtype=torch.float32, requires_grad=True)
    x2 = torch.tensor(rng.normal(size=(2, 13, 4)), dtype=torch.float32, requires_grad=True)
    other = x1 if kind == "self" else x2
    g = torch.as_tensor(rng.normal(size=(2, 20, other.shape[1])), dtype=torch.float32)
    out = lg.lane_gram(x1, other, mode, self_gram=kind == "self", inner=kind == "inner")
    grads = torch.autograd.grad((out * g).sum(), (x1, x2), allow_unused=True)
    a, b = x1.detach().double().requires_grad_(True), x2.detach().double().requires_grad_(True)
    b_used = a if kind == "self" else b
    if kind == "inner":
        ref_out = a @ b_used.mT
    elif kind == "self":
        ref_out = sq_dist_self(a)
    else:
        ref_out = sq_dist(a, b_used)
    ref = torch.autograd.grad((ref_out * g.double()).sum(), (a, b), allow_unused=True)
    for got, want in zip(grads, ref):
        if want is None:
            assert got is None
            continue
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 5e-6


def test_guard_probe_matches_jax(rng):
    x = rng.normal(size=(1, 40, 3)).astype(np.float32)
    y = np.sin(x.sum(-1)).astype(np.float32)
    mask = np.ones((1, 40), np.float32)
    kernel_t = 1.0 * tgp.ARDRBFKernel(3) + tgp.Const(1e-2) * tgp.EyeKernel()
    kernel_j = 1.0 * jgp.ARDRBFKernel(3) + jgp.Const(1e-2) * jgp.EyeKernel()
    theta = kernel_j.init_theta().astype(np.float32)
    for lane in ("strict", "mixed"):
        v_t, g_t = t_probe(kernel_t, torch.as_tensor(theta), torch.as_tensor(x),
                           torch.as_tensor(y), torch.as_tensor(mask), lane=lane)
        v_j, g_j = j_probe(kernel_j, jnp.asarray(theta), jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(mask), lane=lane, solver="exact")
        assert abs(float(v_t) - float(v_j)) <= 1e-5 * abs(float(v_j))
        g_j = np.asarray(g_j, dtype=np.float64)
        assert np.max(np.abs(g_t.double().numpy() - g_j)) <= 1e-5 * np.max(np.abs(g_j))


def _float32_route(kernel, theta, x, y, mask, *, lane):
    """The probe's objective as a float32 fit evaluates it on the card: the
    gram at ``lane``, then K^-1 and log det K by K1's plain version."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack
    from spark_gp_tpu_torch.models.likelihood import nll_from_inverse
    from spark_gp_tpu_torch.ops.spd_linalg import spd_inv_logdet_plain

    with precision_lane_scope(lane), torch.enable_grad():
        t = theta.detach().clone().requires_grad_(True)
        kmat = masked_gram_stack(kernel, t, x, mask)
        value = nll_from_inverse(kmat, y * mask, inv_logdet=spd_inv_logdet_plain)
        (grad,) = torch.autograd.grad(value, t)
    return value.detach(), grad


def _guard_deltas(strict, lane, rows):
    """The guard's (NLL, gradient) deltas over its floored scales
    (``models/common._emit_precision_guard``)."""
    (v_s, g_s), (v_l, g_l) = ((float(v), np.asarray(g, dtype=np.float64))
                              for v, g in (strict, lane))
    scale = max(abs(v_s), rows, 1.0)
    return (abs(v_l - v_s) / scale,
            float(np.max(np.abs(g_l - g_s))) / max(float(np.max(np.abs(g_s))), scale))


@pytest.mark.parametrize("lane", ["mixed", "fast"])
def test_guard_deltas_on_an_ill_conditioned_probe(lane, rng, record_property):
    """At sigma2 1e-4 (cond(K) ~3e5) the port's probe (the lane's float32
    gram, float64 algebra) leaves out the float32 algebra's share of the
    delta that the JAX package's guard and a float32 route through K1's
    plain version both read.  Each route's deltas are recorded; every
    route gives the same verdict: no breach at mixed, and at fast the
    port's routes breach (the 1-pass TF32 gram is not positive definite
    here; XLA's CPU contraction has no TF32, so the JAX package's fast
    lane reads strict's numbers on the CPU and only its deltas are kept)."""
    n = 64
    x = rng.uniform(-1, 1, size=(1, n, 3)).astype(np.float32)
    y = np.sin(3 * x.sum(-1)).astype(np.float32)
    mask = np.ones((1, n), np.float32)
    scales = np.array([0.5, 0.7, 0.9])
    kernel_t = 1.0 * tgp.ARDRBFKernel(scales) + tgp.Const(1e-4) * tgp.EyeKernel()
    kernel_j = 1.0 * jgp.ARDRBFKernel(scales) + jgp.Const(1e-4) * jgp.EyeKernel()
    theta = kernel_j.init_theta().astype(np.float32)
    args_t = [torch.as_tensor(a) for a in (theta, x, y, mask)]
    args_j = [jnp.asarray(a) for a in (theta, x, y, mask)]
    routes = {
        "float64": lambda ln: t_probe(kernel_t, *args_t, lane=ln),
        "float32": lambda ln: _float32_route(kernel_t, *args_t, lane=ln),
        "jax": lambda ln: j_probe(kernel_j, *args_j, lane=ln, solver="exact"),
    }
    deltas = {name: _guard_deltas(probe("strict"), probe(lane), n)
              for name, probe in routes.items()}
    for name, (d_nll, d_grad) in deltas.items():
        record_property(f"{name}.delta_nll_rel", d_nll)
        record_property(f"{name}.delta_grad_rel", d_grad)
    bar = precision.GUARD_BARS[lane]
    breach = {name: not (np.all(np.isfinite(d)) and max(d) <= bar)
              for name, d in deltas.items()}
    if lane == "mixed":
        assert breach == {"float64": False, "float32": False, "jax": False}
    else:
        assert breach["float64"] and breach["float32"]


def _small_fit(lane):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 2))
    y = np.sin(x.sum(1)) + 0.05 * rng.normal(size=200)
    gp = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
          .setDatasetSizeForExpert(50).setActiveSetSize(30).setSigma2(1e-3).setMaxIter(4)
          .setSeed(7))
    if lane is not None:
        gp.setPrecisionLane(lane)
    return gp.fit(x, y)


def test_mixed_fit_emits_precision_guard():
    model = _small_fit("mixed")
    set_precision_lane(None)
    metrics = model.metrics
    assert metrics["precision_lane"] == "mixed"
    assert model.run_journal["precision_lane"] == "mixed"
    for leg in ("delta_nll_rel", "delta_grad_rel", "delta_predict_rel"):
        # float64 on the CPU: the lanes' grams are the strict lane's
        assert metrics[f"mixed_precision_guard.{leg}"] == 0.0
    assert metrics["mixed_precision_guard.breach"] == 0.0
    strict = _small_fit(None)
    assert strict.metrics["precision_lane"] == "strict"
    assert not any(k.startswith("mixed_precision_guard.") for k in strict.metrics)
    assert np.array_equal(strict.predict(np.zeros((3, 2))), model.predict(np.zeros((3, 2))))


def test_lane_plumbing_env_setter_scope_roundtrip(monkeypatch):
    assert active_lane() == "strict" and get_policy() == LANES["strict"]
    monkeypatch.setenv("GP_PRECISION_LANE", "mixed")
    assert active_lane() == "mixed" and get_policy().gram == "compensated"
    assert set_precision_lane("fast") is None
    assert active_lane() == "fast"
    assert set_precision_lane("strict") == "fast"
    with precision_lane_scope("mixed"):
        assert active_lane() == "mixed"
        with precision_lane_scope("fast"):
            assert active_lane() == "fast"
        assert active_lane() == "mixed"
    assert active_lane() == "strict"
    with precision_lane_scope(None):
        assert active_lane() == "strict"
    set_precision_lane(None)
    assert active_lane() == "mixed"
    # the errors name their source, in the JAX package's words
    monkeypatch.setenv("GP_PRECISION_LANE", "bf16")
    for pkg in (precision, j_precision):
        with pytest.raises(ValueError, match="GP_PRECISION_LANE='bf16' is not a precision lane"):
            pkg.active_lane()
    monkeypatch.delenv("GP_PRECISION_LANE")
    with pytest.raises(ValueError, match="set_precision_lane='fastest'"):
        set_precision_lane("fastest")
    with pytest.raises(ValueError, match="precision_lane_scope='loose'"):
        with precision_lane_scope("loose"):
            pass
    monkeypatch.setenv("GP_PRECISION_GRAM", "high")
    monkeypatch.setenv("GP_MATMUL_PRECISION", "highest")
    assert get_policy() == ("strict", "high")
    assert j_precision.get_policy()[:2] == ("strict", "high")
    assert precision.gram_mode() == "high"
    # the port's linear algebra has one precision: a lower pin is refused
    for pin in ("high", "default"):
        monkeypatch.setenv("GP_MATMUL_PRECISION", pin)
        with pytest.raises(ValueError, match=f"GP_MATMUL_PRECISION='{pin}' has no effect"):
            get_policy()
    monkeypatch.delenv("GP_MATMUL_PRECISION")
    with precision_lane_scope("fast"):
        x = torch.ones(3, 2)
        assert torch.equal(sq_dist(x, x), lg.lane_gram(x, x, "tf32"))
    for name, bad in (("GP_PRECISION_GRAM", "six-pass"), ("GP_MATMUL_PRECISION", "bf16")):
        monkeypatch.setenv(name, bad)
        for pkg in (precision, j_precision):
            with pytest.raises(ValueError, match=f"{name}='{bad}' is not supported"):
                pkg.get_policy()
        monkeypatch.delenv(name)
    assert {k: v.gram for k, v in precision.LANES.items()} == \
        {k: v.gram for k, v in j_precision.LANES.items()}
    assert precision.GUARD_BARS == j_precision.GUARD_BARS
    assert precision.GUARD_ACTIONS == j_precision.GUARD_ACTIONS


def test_estimator_setter_is_fluent_and_process_wide():
    gp = tgp.GaussianProcessRegression(device="cpu")
    assert gp.setPrecisionLane("mixed") is gp
    assert active_lane() == "mixed"
    gp.set_precision_lane("strict")
    assert active_lane() == "strict"
    with pytest.raises(ValueError, match="set_precision_lane='turbo'"):
        gp.setPrecisionLane("turbo")


def test_batcher_pins_its_construction_lane():
    """The batcher needs no lane pin: its predict block is float64, which
    no lane reaches, so batchers built and run at any lane agree bit for
    bit."""
    from spark_gp_tpu_torch.serve.batcher import BucketedPredictor

    model = _small_fit(None)
    x = np.random.default_rng(3).normal(size=(5, 2)).astype(np.float32)
    outs = {}
    for lane in LANES:
        with precision_lane_scope(lane):
            outs[lane] = BucketedPredictor(model.raw_predictor, max_batch=16).predict(x)
    assert active_lane() == "strict"
    for lane in ("mixed", "fast"):
        for got, want in zip(outs[lane], outs["strict"]):
            assert np.array_equal(got, want)


def _tf32_writes(path: Path):
    """Lines of ``path`` that assign to an ``allow_tf32`` attribute."""
    tree = ast.parse(path.read_text())
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, (ast.Assign, ast.AugAssign))
            and any(isinstance(t, ast.Attribute) and t.attr == "allow_tf32"
                    for t in (node.targets if isinstance(node, ast.Assign) else [node.target]))]


def test_no_allow_tf32_write_outside_ops_precision():
    files = sorted((ROOT / "spark_gp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    writes = {str(f.relative_to(ROOT)): _tf32_writes(f) for f in files}
    offenders = {f: lines for f, lines in writes.items()
                 if lines and f != os.path.join("spark_gp_tpu_torch", "ops", "precision.py")}
    assert offenders == {}
    assert writes[os.path.join("spark_gp_tpu_torch", "ops", "precision.py")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_kernel_matches_its_plain_version_on_the_card(mode, rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lane kernel has no CPU form")
    for b, n1, n2, p, self_gram, inner in ((14, 97, 97, 5, True, False),
                                           (2, 130, 70, 33, False, False),
                                           (1, 20, 64, 9, False, True)):
        x1 = torch.tensor(rng.normal(size=(b, n1, p)), dtype=torch.float32, device="cuda")
        x2 = x1 if self_gram else torch.tensor(rng.normal(size=(b, n2, p)),
                                               dtype=torch.float32, device="cuda")
        got = lg.lane_gram(x1, x2, mode, self_gram=self_gram, inner=inner)
        ref = lg.lane_gram_plain(x1, x2, mode, self_gram, inner)
        sq1, sq2 = (float(x.double().pow(2).sum(-1).max()) for x in (x1, x2))
        scale = (sq1 * sq2) ** 0.5 if inner else sq1 + sq2
        assert float((got - ref).abs().max()) <= 1e-5 * scale
        if self_gram:
            assert bool((torch.diagonal(got, dim1=-2, dim2=-1) == 0).all())
