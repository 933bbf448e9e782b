"""The Gauss quadrature of stochastic Lanczos quadrature, per probe.

``ops/iterative.py`` estimates ``log|A|`` from the PCG coefficients: each
probe's Lanczos tridiagonal ``T`` (:func:`lanczos_tridiagonal`) gives the
quadrature ``sum_j (e1^T v_j)^2 log(lambda_j)`` over its eigenpairs
(Golub-Welsch).  :func:`slq_quadrature` computes it for a ``[..., t]``
stack of tridiagonals:

* on a CUDA float32 or float64 stack it launches the hand-written kernel
  ``csrc/slq_quadrature.cu`` (one block a matrix, T in shared memory: the
  leading unreduced block's ``e1^T log(T) e1`` as a trapezoid rule over
  ``int_0^inf (1/(1+s) - e1^T (T + sI)^-1 e1) ds``, one pivot pass a node
  and a thread; a T with an eigenvalue under the clamp runs implicit-shift
  QL; above 1024 rows T lives in a workspace the wrapper allocates, so any
  ``t``), which a CUDA graph can capture: the device optimizer's step on
  the CG lanes holds it;
* on a CPU tensor it runs :func:`slq_quadrature_plain`, the JAX package's
  route: the dense ``T``, one batched ``torch.linalg.eigh``, the first
  components of the eigenvectors;
* anything else on CUDA raises.

The kernel is exact for its inputs (double inside), where float32
``eigh`` on the card is off by ~2e-5 a probe (PERF.md §6).  No gradient:
the SLQ value is the forward-only part of the estimate, its gradient
comes from the probe solves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import cuda_lib


def lanczos_tridiagonal(alphas, betas):
    """``(diag [..., n, t], off [..., n, t - 1])`` of the Lanczos tridiagonal
    of each right-hand side, from ``[t, ..., n]`` PCG records:
    ``T_jj = 1/alpha_j + beta_{j-1}/alpha_{j-1}`` and ``T_{j,j+1} =
    sqrt(beta_j)/alpha_j``."""
    a = torch.movedim(alphas, 0, -1)  # [..., n, t]
    b = torch.movedim(betas, 0, -1)
    inv_a = 1.0 / a
    diag = inv_a + torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1] * inv_a[..., :-1]],
                             dim=-1)
    off = torch.sqrt(torch.clamp_min(b[..., :-1], 0.0)) * inv_a[..., :-1]
    return diag, off


def slq_quadrature_plain(diag, off):
    """``[...]``: the quadrature of each tridiagonal by one batched
    ``eigh`` of the dense ``T`` (eigenvalues clamped at 1e-12 before the
    log)."""
    tmat = torch.diag_embed(diag)
    if diag.shape[-1] > 1:
        tmat = tmat + torch.diag_embed(off, offset=1) + torch.diag_embed(off, offset=-1)
    evals, evecs = torch.linalg.eigh(tmat)
    log_evals = torch.log(torch.clamp_min(evals, 1e-12))
    e1sq = evecs[..., 0, :] ** 2  # first component of each eigenvector
    return torch.sum(e1sq * log_evals, dim=-1)


#: double operations of one QL rotation of the first design: hypot (two
#: products, a sum, a square root), two divisions, the rotated diagonal
#: pair (five), the next shift (two) and the eigenvector row (six)
OPS_PER_ROTATION = 25


def work(batch: int, t: int, itemsize: int = 4):
    """``(flops, bytes)`` of one quadrature launch over ``batch``
    tridiagonals of ``t`` rows, from the shapes alone: each matrix's
    diagonal, off-diagonal and result moved once, and the first design's
    Golub-Welsch QL at its textbook count, two implicit-shift iterations
    an eigenvalue over on average half the rows still unreduced, i.e.
    ``t^2`` rotations a matrix of :data:`OPS_PER_ROTATION` double
    operations each.  (``chip_smoke.py``'s bound counts this run's own
    rotations, which depend on the data.)"""
    return (float(batch * t * t * OPS_PER_ROTATION),
            float((batch * t + batch * max(t - 1, 0) + batch) * itemsize))


def kernel_applies(diag: torch.Tensor) -> bool:
    """A CUDA float32 or float64 stack of tridiagonals of at least one row."""
    return (diag.is_cuda and diag.dtype in (torch.float32, torch.float64)
            and diag.shape[-1] >= 1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/slq_quadrature.cu``."""
    for fn in (lib.slq_quadrature_f32, lib.slq_quadrature_f64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.slq_quadrature_workspace_doubles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.slq_quadrature_workspace_doubles.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(cuda_lib.load("slq_quadrature"))


def _launch(diag, off, steps=None):
    """The kernel on a ``[..., t]`` stack; ``steps`` (an int32 tensor of
    the stack's leading shape, or None) receives each matrix's work count
    (the kernel's pivot steps or QL rotations; the first design's QL
    rotations)."""
    if not kernel_applies(diag) or off.dtype != diag.dtype or off.device != diag.device \
            or tuple(off.shape) != tuple(diag.shape[:-1]) + (diag.shape[-1] - 1,):
        raise ValueError(
            f"slq_quadrature on the card takes a float32 or float64 [..., t] CUDA "
            f"stack and its [..., t - 1] off-diagonals; got "
            f"{diag.dtype} {tuple(diag.shape)} and {off.dtype} {tuple(off.shape)} "
            f"on {diag.device}")
    t = diag.shape[-1]
    d = diag.reshape(-1, t).contiguous()
    o = off.reshape(d.shape[0], t - 1).contiguous()
    out = torch.empty(d.shape[0], dtype=diag.dtype, device=diag.device)
    if out.numel() == 0:
        return out.reshape(diag.shape[:-1])
    if steps is not None and (steps.dtype != torch.int32 or not steps.is_contiguous()
                              or steps.numel() != out.numel()):
        raise ValueError("steps must be a contiguous int32 tensor, one entry a matrix")
    lib = _library()
    workspace = torch.empty(lib.slq_quadrature_workspace_doubles(d.shape[0], t),
                            dtype=torch.float64, device=diag.device)
    entry = lib.slq_quadrature_f32 if diag.dtype == torch.float32 else lib.slq_quadrature_f64
    with torch.cuda.device(diag.device):
        err = entry(d.data_ptr(), o.data_ptr(), out.data_ptr(),
                    None if steps is None else steps.data_ptr(), workspace.data_ptr(),
                    d.shape[0], t, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise cuda_lib.KernelLaunchError(f"slq_quadrature kernel launch failed: CUDA error {err}")
    cuda_lib.record_launch(slq_quadrature, "slq_quadrature",
                           work(d.shape[0], t, diag.element_size()))
    return out.reshape(diag.shape[:-1])


def slq_quadrature(diag, off):
    """``[...]``: the quadrature of each tridiagonal (module doc); the
    kernel on the card, the plain version on the CPU."""
    with obs_cost.library_paused():
        if diag.device.type == "cpu":
            out = slq_quadrature_plain(diag, off)
            cuda_lib.record_plain("slq_quadrature",
                                  work(out.numel(), diag.shape[-1], diag.element_size()))
            return out
        return _launch(diag, off)


#: kernel launches since the last reset (the wrapper's launch counter)
slq_quadrature.launches = 0
