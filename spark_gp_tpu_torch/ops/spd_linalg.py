"""Batched SPD inverse + log-determinant: the port of ``ops/pallas_linalg.py``.

The BCM likelihood needs, for every expert's ``s x s`` gram: ``log|K|``,
``alpha = K^-1 y`` and, for the gradient, the full ``K^-1``
(``dNLL/dK = 0.5 (K^-1 - alpha alpha^T)``).  :func:`spd_inv_logdet` computes
``(K^-1, log|K|)`` for a ``[B, n, n]`` batch in one pass:

* on a CUDA float32 batch with ``n <= 512`` it launches the hand-written
  kernels of ``csrc/spd_inv_logdet.cu``: a blocked Cholesky, ``W = L^-1``
  block row by block row, ``K^-1 = W^T W``; up to ``n = 128`` one thread
  block per matrix in shared memory, above it a sequence of launches over
  32 x 32 tiles of a workspace (many blocks per matrix), whose size the
  library reports.  The launch counter counts one per call, however many
  CUDA launches the call makes; a call made while a CUDA graph captures
  (the device optimizer's step) counts once per replay of the graph
  (``ops/cuda_lib.record_launch``);
* on a CPU tensor it runs :func:`spd_inv_logdet_plain`, the same function
  in plain PyTorch (Cholesky, logdet from the diagonal, ``cholesky_inverse``);
* anything else on CUDA raises -- there is no silent fallback.

:func:`batched_spd_inv_logdet` is the callers' gate: K1 on a stack the
kernel takes (:func:`kernel_applies`), one batched Cholesky otherwise --
the CPU, float64, and a CUDA stack with ``n > 512``.

A non-PD matrix yields NaN for that matrix, never an exception.  The
gradient is a :class:`torch.autograd.Function` whose backward is the JAX
package's VJP, ``K_bar = -K^-1 G K^-1 + g_logdet K^-1``: two batched
matmuls, no triangular solves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import cuda_lib
from spark_gp_tpu_torch.ops.linalg import chol_logdet, chol_solve, cholesky

N_MAX = 512  # largest matrix the kernel takes


def spd_inv_logdet_plain(k: torch.Tensor):
    """``[B, n, n] -> (K^-1, logdet [B])`` in plain PyTorch: one Cholesky,
    logdet from its diagonal, the inverse by ``cholesky_inverse``.  A non-PD
    matrix gives NaN in both outputs for that matrix."""
    chol = cholesky(k)
    return torch.cholesky_inverse(chol), chol_logdet(chol)


def work(batch: int, n: int, itemsize: int = 4):
    """``(flops, bytes)`` of one K1 call on ``[batch, n, n]``, whatever
    design runs it: ``batch n^3`` flops (the Cholesky, ``L^-1`` and
    ``W^T W``, ``n^3 / 3`` each) and ``K`` read once, ``K^-1`` and the
    log-determinants written once."""
    return float(batch * n ** 3), float(2 * batch * n * n * itemsize + batch * itemsize)


def kernel_applies(k: torch.Tensor) -> bool:
    """The batched-inverse gate of ``batched_nll``: a CUDA float32
    ``[B, n, n]`` stack with ``n <= 512`` (the JAX package's ``_use_pallas``
    with the card in place of the TPU)."""
    return (
        k.is_cuda
        and k.dtype == torch.float32
        and k.ndim == 3
        and k.shape[-1] == k.shape[-2]
        and k.shape[-1] <= N_MAX
    )


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/spd_inv_logdet.cu``."""
    fn = lib.spd_inv_logdet_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.spd_inv_logdet_smem_max_n.argtypes = []
    lib.spd_inv_logdet_smem_max_n.restype = ctypes.c_int
    lib.spd_inv_logdet_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.spd_inv_logdet_workspace_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(cuda_lib.load("spd_inv_logdet"))


def _launch(k: torch.Tensor):
    k = k.contiguous()
    batch, n = k.shape[0], k.shape[-1]
    kinv = torch.empty_like(k)
    logdet = torch.empty(batch, dtype=k.dtype, device=k.device)
    if k.numel() == 0:
        return kinv, logdet.zero_()
    lib = _library()
    # above the library's shared-memory limit the kernel works in a
    # workspace of the size the library asks for
    floats = lib.spd_inv_logdet_workspace_floats(batch, n)
    workspace = torch.empty(floats, dtype=k.dtype, device=k.device) if floats else None
    with torch.cuda.device(k.device):
        err = lib.spd_inv_logdet_f32(
            k.data_ptr(), kinv.data_ptr(), logdet.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            batch, n, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise cuda_lib.KernelLaunchError(f"spd_inv_logdet kernel launch failed: CUDA error {err}")
    cuda_lib.record_launch(spd_inv_logdet, "spd_inv_logdet", work(batch, n, k.element_size()))
    return kinv, logdet


def _forward(k: torch.Tensor):
    with obs_cost.library_paused():
        if k.device.type == "cpu":
            out = spd_inv_logdet_plain(k)
            cuda_lib.record_plain("spd_inv_logdet",
                                  work(k.shape[0], k.shape[-1], k.element_size()))
            return out
        if not kernel_applies(k):
            raise ValueError(
                "spd_inv_logdet on the card takes a float32 [B, n, n] CUDA tensor "
                f"with n <= {N_MAX}; got {k.dtype} {tuple(k.shape)} on {k.device}"
            )
        return _launch(k)


class _SpdInvLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k):
        ctx.set_materialize_grads(False)
        kinv, logdet = _forward(k)
        ctx.save_for_backward(kinv)
        return kinv, logdet

    @staticmethod
    def backward(ctx, g_kinv, g_logdet):
        (kinv,) = ctx.saved_tensors
        # d logdet/dK = K^-1 (symmetric); d K^-1/dK applied to G is
        # -K^-1 G K^-1
        kbar = torch.zeros_like(kinv)
        if g_kinv is not None:
            kbar = kbar - kinv @ g_kinv @ kinv
        if g_logdet is not None:
            kbar = kbar + g_logdet[:, None, None] * kinv
        return kbar


def spd_inv_logdet(k: torch.Tensor):
    """``[B, n, n] SPD -> (K^-1 [B, n, n], logdet [B])``, differentiable.
    The kernel on the card, the plain version on the CPU (module doc)."""
    return _SpdInvLogdet.apply(k)


#: kernel launches since the last reset (the wrapper's launch counter)
spd_inv_logdet.launches = 0


def batched_spd_inv_logdet(mats):
    """``(B^-1, logdet B)`` of an ``[..., s, s]`` SPD stack, flattened to
    one ``[B, s, s]`` batch before the call: K1 on a stack it takes
    (:func:`kernel_applies`), else one batched Cholesky, whose inverse is
    two triangular solves against the identity."""
    shape = mats.shape
    flat = mats.reshape((-1,) + shape[-2:])
    if kernel_applies(flat):
        inv, logdet = spd_inv_logdet(flat)
    else:
        chol_l = cholesky(flat)
        eye = torch.eye(shape[-1], dtype=mats.dtype, device=mats.device).expand(flat.shape)
        inv, logdet = chol_solve(chol_l, eye), chol_logdet(chol_l)
    return inv.reshape(shape), logdet.reshape(shape[:-2])
