"""The port's streamed gram-matrix product (``ops/streamed_matvec.py``).

On the CPU the wrapper runs its plain version; it is held against the JAX
package's ``streamed_matvec`` (float64, every tile transform, a tile that
does not divide s: 1e-10), and its autograd backward against ``jax.grad``
of the differentiable scan (1e-9).  The two CUDA kernels run only on a
card: the ``cuda``-marked tests skip here.
"""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_gp_tpu.ops.pallas_matvec import TILE_TRANSFORMS as J_TRANSFORMS
from spark_gp_tpu.ops.pallas_matvec import streamed_matvec as j_matvec
from spark_gp_tpu_torch.ops import cuda_lib
from spark_gp_tpu_torch.ops import streamed_matvec as sm

DEGREE = 3

#: family -> (params, the JAX package's tile map)
FAMILIES = {
    "rbf": ([0.7], J_TRANSFORMS["rbf"]),
    "matern12": ([0.8], J_TRANSFORMS["matern12"]),
    "matern32": ([0.8], J_TRANSFORMS["matern32"]),
    "matern52": ([0.8], J_TRANSFORMS["matern52"]),
    "rq": ([0.9, 1.3], J_TRANSFORMS["rq"]),
    "dot": ([0.5], J_TRANSFORMS["dot"]),
    # the JAX PolynomialKernel passes this closure for its static degree
    "poly": ([0.7], lambda par, inner: (inner + par[0]) ** DEGREE),
}


def _inputs(seed=0, shape=(2, 53, 4), n=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape[:2] + (n,))


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b)))


def test_registry_covers_the_seven_families():
    assert set(sm.TILE_TRANSFORMS) == set(FAMILIES)
    assert sorted(t.fid for t in sm.TILE_TRANSFORMS.values()) == list(range(7))
    kinds = {name: t.kind for name, t in sm.TILE_TRANSFORMS.items()}
    assert {n for n, k in kinds.items() if k == "inner"} == {"dot", "poly"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("vector", [False, True])
def test_plain_matches_jax(family, vector):
    """Batched, ragged tile (16 does not divide 53), matrix or vector RHS."""
    params, j_map = FAMILIES[family]
    x, v = _inputs()
    if vector:
        v = v[..., 0]
    kind = sm.TILE_TRANSFORMS[family].kind
    want = j_matvec(jnp.asarray(x), jnp.asarray(v), j_map, jnp.asarray(params),
                    kind=kind, tile=16)
    got = sm.streamed_matvec_plain(torch.as_tensor(x), torch.as_tensor(v), family,
                                   torch.tensor(params, dtype=torch.float64),
                                   degree=DEGREE, tile=16)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-10
    # the entry point (plain on the CPU) equals the plain version
    entry = sm.streamed_matvec(torch.as_tensor(x), torch.as_tensor(v), family,
                               torch.tensor(params, dtype=torch.float64), degree=DEGREE)
    assert _rel(entry.numpy(), want) <= 1e-10


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_matches_jax_wide_features(family):
    """p above the kernel's 16-feature chunk, s ragged against every tile,
    and the CG step's width n = 9."""
    params, j_map = FAMILIES[family]
    x, v = _inputs(seed=3, shape=(2, 37, 21), n=9)
    x = x / np.sqrt(x.shape[-1])
    kind = sm.TILE_TRANSFORMS[family].kind
    want = j_matvec(jnp.asarray(x), jnp.asarray(v), j_map, jnp.asarray(params),
                    kind=kind, tile=16)
    got = sm.streamed_matvec(torch.as_tensor(x), torch.as_tensor(v), family,
                             torch.tensor(params, dtype=torch.float64), degree=DEGREE)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-10


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradients_match_jax(family):
    """theta- and v-gradients of ``sum(w * (K v))`` through the autograd
    Function against ``jax.grad`` of the differentiable (scan) path."""
    params, j_map = FAMILIES[family]
    x, v = _inputs(seed=1)
    w = np.random.default_rng(2).normal(size=v.shape)
    kind = sm.TILE_TRANSFORMS[family].kind

    def j_loss(par, vv):
        out = j_matvec(jnp.asarray(x), vv, j_map, par, kind=kind, tile=16,
                       differentiable=True)
        return jnp.sum(jnp.asarray(w) * out)

    j_gp, j_gv = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(params), jnp.asarray(v))
    par = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    vv = torch.as_tensor(v).requires_grad_(True)
    loss = torch.sum(torch.as_tensor(w) * sm.streamed_matvec(torch.as_tensor(x), vv, family,
                                                             par, degree=DEGREE))
    t_gp, t_gv = torch.autograd.grad(loss, (par, vv))
    assert _rel(t_gp.numpy(), j_gp) <= 1e-9
    assert _rel(t_gv.numpy(), j_gv) <= 1e-9
    # the VJP entry's plain counterpart gives the same theta-cotangent
    vjp = sm.streamed_matvec_vjp(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(v),
                                 family, par.detach(), DEGREE)
    assert _rel(vjp.numpy(), j_gp) <= 1e-9


def test_cpu_never_counts_a_launch_and_bad_input_raises():
    x, v = _inputs()
    par = torch.tensor([0.7], dtype=torch.float64, requires_grad=True)
    before = (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches)
    out = sm.streamed_matvec(torch.as_tensor(x), torch.as_tensor(v), "rbf", par)
    out.sum().backward()
    assert (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches) == before
    with pytest.raises(ValueError, match="row stack x"):
        sm.streamed_matvec(torch.as_tensor(x).requires_grad_(True), torch.as_tensor(v), "rbf", par)
    with pytest.raises(ValueError, match="unknown tile transform"):
        sm.streamed_matvec(torch.as_tensor(x), torch.as_tensor(v), "periodic", par)
    meta = torch.empty((2, 8, 3), device="meta")
    assert not sm.kernel_applies(meta) and not sm.kernel_applies(torch.as_tensor(x).float())
    with pytest.raises(ValueError, match="CUDA row"):
        sm.streamed_matvec(meta, torch.empty((2, 8, 1), device="meta"), "rbf",
                           torch.empty(1, device="meta"))


def test_matvec_tiles_and_library_path():
    assert sm.matvec_tiles(4065) == 64 and sm.matvec_tiles(64) == 1 and sm.matvec_tiles(65) == 2
    path = cuda_lib.library_path("streamed_matvec")
    assert path.parent == cuda_lib.BUILD_DIR and path.name.startswith("libstreamed_matvec-")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((3, 1000, 5), 1), ((2, 130, 20), 4), ((2, 130, 20), 17),
                                     ((9, 4065, 9), 1), ((9, 4065, 9), 8), ((9, 4065, 9), 9),
                                     ((2, 777, 21), 9), ((3, 1000, 5), 9), ((1, 7, 3), 9)])
def test_kernels_match_plain_on_card(shape, n):
    """Both kernels against the plain version in float64 on the same
    inputs: K2 within 1e-5 of the largest output, the VJP within 1e-4 of
    the plain cotangent, for every family; the shapes cover every
    accumulator width, s ragged against the tiles and smaller than one,
    and p over one feature chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=shape) / np.sqrt(shape[-1]), dtype=torch.float32, device="cuda")
    v = torch.as_tensor(rng.normal(size=shape[:2] + (n,)), dtype=torch.float32, device="cuda")
    w = torch.as_tensor(rng.normal(size=shape[:2] + (n,)), dtype=torch.float32, device="cuda")
    for family, (params, _) in FAMILIES.items():
        par = torch.tensor(params, dtype=torch.float32, device="cuda")
        before = sm.streamed_matvec.launches
        out = sm.streamed_matvec(x, v, family, par, degree=2)
        grad = sm.streamed_matvec_vjp(x, w, v, family, par, degree=2)
        torch.cuda.synchronize()
        assert sm.streamed_matvec.launches == before + 1
        ref = sm.streamed_matvec_plain(x.double(), v.double(), family, par.double(), degree=2)
        gref = sm.streamed_matvec_vjp_plain(x.double(), w.double(), v.double(), family,
                                            par.double(), degree=2)
        assert (out.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
        assert (grad.double() - gref).abs().max().item() <= 1e-4 * gref.abs().max().item()
