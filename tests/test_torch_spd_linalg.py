"""The port's batched SPD inverse + logdet (``ops/spd_linalg.py``).

On the CPU the wrapper runs its plain version; it is held against the JAX
package's Cholesky fallback (float64, rtol 1e-12) and its Pallas kernel in
interpret mode (float32, the JAX test's bars).  The CUDA kernel itself
runs only on a card: the ``cuda``-marked test skips here.
"""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_gp_tpu.ops.pallas_linalg import _chol_inv_logdet, _pallas_inv_logdet
from spark_gp_tpu_torch.ops import cuda_lib
from spark_gp_tpu_torch.ops.spd_linalg import (
    kernel_applies,
    spd_inv_logdet,
    spd_inv_logdet_plain,
)


def _spd_batch(b, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(dtype)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("b,n", [(1, 4), (4, 32), (3, 100)])
def test_plain_matches_jax_cholesky_f64(b, n):
    k = _spd_batch(b, n, seed=n)
    j_kinv, j_ld = _chol_inv_logdet(jnp.asarray(k))
    t_kinv, t_ld = spd_inv_logdet_plain(torch.as_tensor(k))
    scale = np.max(np.abs(np.asarray(j_kinv)))
    np.testing.assert_allclose(t_kinv.numpy(), np.asarray(j_kinv), rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(t_ld.numpy(), np.asarray(j_ld), rtol=1e-12)


@pytest.mark.parametrize("b,n", [(3, 100), (5, 60)])
def test_plain_matches_pallas_interpret_f32(b, n):
    k = _spd_batch(b, n, seed=b, dtype=np.float32)
    j_kinv, j_ld = _pallas_inv_logdet(jnp.asarray(k), interpret=True)
    t_kinv, t_ld = spd_inv_logdet_plain(torch.as_tensor(k))
    assert t_kinv.dtype == torch.float32
    scale = np.max(np.abs(np.asarray(j_kinv)))
    np.testing.assert_allclose(t_kinv.numpy(), np.asarray(j_kinv), atol=5e-5 * scale)
    np.testing.assert_allclose(t_ld.numpy(), np.asarray(j_ld), rtol=1e-5, atol=1e-4)


def test_backward_matches_autograd_through_cholesky():
    """The autograd function's VJP against autograd through the Cholesky
    formulation of the same NLL (the JAX package's bar, rtol 1e-8)."""
    k = torch.as_tensor(_spd_batch(3, 20, seed=3))
    y = torch.as_tensor(np.random.default_rng(4).normal(size=(3, 20)))

    def via_entry(km):
        kinv, ld = spd_inv_logdet(km)
        alpha = torch.einsum("bij,bj->bi", kinv, y)
        return 0.5 * torch.einsum("bi,bi->", y, alpha) + 0.5 * ld.sum()

    def via_chol(km):
        chol = torch.linalg.cholesky(km)
        sol = torch.cholesky_solve(y[..., None], chol)[..., 0]
        ld = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return 0.5 * torch.einsum("bi,bi->", y, sol) + 0.5 * ld.sum()

    grads = []
    for fn in (via_entry, via_chol):
        kk = k.clone().requires_grad_(True)
        fn(kk).backward()
        grads.append(kk.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("which", ["kinv", "logdet"])
def test_backward_with_one_output_unused(which):
    k = torch.as_tensor(_spd_batch(2, 6, seed=5)).requires_grad_(True)
    kinv, ld = spd_inv_logdet(k)
    (kinv.sum() if which == "kinv" else ld.sum()).backward()
    kk = k.detach().clone().requires_grad_(True)
    ref_kinv, ref_ld = spd_inv_logdet_plain(kk)
    # symmetric cotangents agree with the Cholesky backward's symmetrized grad
    (ref_kinv.sum() if which == "kinv" else ref_ld.sum()).backward()
    np.testing.assert_allclose(k.grad.numpy(), kk.grad.numpy(), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_non_pd_gives_nan_for_that_matrix_only(dtype):
    k = torch.eye(8, dtype=dtype)[None].repeat(3, 1, 1)
    k[1, 0, 0] = -1.0
    before = spd_inv_logdet.launches
    kinv, ld = spd_inv_logdet(k)
    assert torch.isfinite(ld[[0, 2]]).all() and torch.isnan(ld[1])
    assert torch.isfinite(kinv[[0, 2]]).all() and torch.isnan(kinv[1]).all()
    assert spd_inv_logdet.launches == before  # a CPU tensor never reaches the kernel


def test_wrapper_gate_and_raise():
    k = torch.as_tensor(_spd_batch(2, 8, dtype=np.float32))
    assert not kernel_applies(k)  # CPU: the plain version
    meta = torch.empty((2, 8, 8), device="meta")
    assert not kernel_applies(meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spd_inv_logdet(meta)


def test_library_path_tracks_source_and_flags():
    path = cuda_lib.library_path("spd_inv_logdet")
    assert path.parent == cuda_lib.BUILD_DIR and path.name.startswith("libspd_inv_logdet-")
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(3, 100), (366, 100), (2, 256), (3, 451), (91, 403)])
def test_kernel_matches_plain_on_card(b, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    k = torch.as_tensor(_spd_batch(b, n, dtype=np.float32), device="cuda")
    before = spd_inv_logdet.launches
    kinv, ld = spd_inv_logdet(k)
    torch.cuda.synchronize()
    assert spd_inv_logdet.launches == before + 1
    ref_kinv, ref_ld = spd_inv_logdet_plain(k.double())
    scale = ref_kinv.abs().max().item()
    assert (kinv.double() - ref_kinv).abs().max().item() <= 5e-5 * scale
    assert bool(((ld.double() - ref_ld).abs() <= 1e-4 + 1e-5 * ref_ld.abs()).all())
