"""Fused gram-matrix product ``K(theta) @ V``: the port of ``ops/pallas_matvec.py``.

The matrix-free solver lane (``ops/iterative.py``) only ever needs
``K @ v``.  For a kernel that is an elementwise map of a raw tile -- the
squared distance ``|xi|^2 + |xj|^2 - 2 <xi, xj>`` (``kind="sqdist"``:
clamped at 0, the diagonal pinned to 0) or the inner product
(``kind="inner"``) -- :func:`streamed_matvec` computes it tile by tile, so
the ``[s, s]`` gram never exists:

* on a CUDA float32 stack it launches the hand-written kernel
  ``csrc/streamed_matvec.cu`` (any ``s``, ``p`` and ``n``); its
  :class:`torch.autograd.Function` backward launches the theta-VJP kernel
  of the same file for ``params`` and the forward kernel again on the
  cotangent for ``v`` (``K`` is symmetric);
* on a CPU tensor it runs :func:`streamed_matvec_plain`, row panels times
  column tiles in plain PyTorch, and differentiates it with autograd;
* anything else on CUDA raises -- there is no silent fallback.

The tile maps live here, one definition per family, and the kernel
classes build their ``gram`` / ``cross`` from the same functions.  The
family ids and parameter layouts are the CUDA kernel's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import cuda_lib

#: rows per block of the CUDA forward kernel: the row tile of ``solver.matvec_tiles``
ROW_TILE = 64
#: column tile of the plain version (the JAX package's default tile)
PLAIN_TILE = 512
#: the Matern sqrt guard: the derivative stays finite on the pinned diagonal
R2_FLOOR = 1e-24


def rbf_tile(params, sqd, degree: int = 1):
    """``exp(-r / (2 sigma^2))``."""
    sigma = params[0]
    return torch.exp(sqd / (-2.0 * sigma * sigma))


def safe_r(sqd):
    """``sqrt(max(r^2, 1e-24))``: the Matern distance, with a finite
    derivative at coincident points."""
    return torch.sqrt(torch.clamp_min(sqd, R2_FLOOR))


def matern_tile(nu2: int, params, sqd, degree: int = 1):
    """Matern with ``2 nu = nu2`` in {1, 3, 5} of the scaled distance
    ``a = sqrt(nu2) r / sigma``."""
    return matern_of_a(nu2, math.sqrt(nu2) * safe_r(sqd) / params[0])


def matern_of_a(nu2: int, a):
    """The Matern correlation of the scaled distance ``a``."""
    if nu2 == 1:
        return torch.exp(-a)
    if nu2 == 3:
        return (1.0 + a) * torch.exp(-a)
    if nu2 == 5:
        return (1.0 + a + a * a / 3.0) * torch.exp(-a)
    raise ValueError(f"unsupported 2*nu = {nu2}")


def rq_tile(params, sqd, degree: int = 1):
    """``(1 + r / (2 alpha sigma^2))^-alpha`` in the exp/log form, so the
    alpha-gradient goes through ``log(base)``."""
    sigma, alpha = params[0], params[1]
    base = 1.0 + sqd / (2.0 * alpha * sigma * sigma)
    return torch.exp(-alpha * torch.log(base))


def dot_tile(params, inner, degree: int = 1):
    """``sigma0^2 + <x, x'>``."""
    return params[0] * params[0] + inner


def poly_tile(params, inner, degree: int = 1):
    """``(<x, x'> + c)^degree`` by repeated multiplication."""
    base = inner + params[0]
    out = base
    for _ in range(int(degree) - 1):
        out = out * base
    return out


class TileTransform(NamedTuple):
    """A family's id in the CUDA kernel, its raw-tile kind, its parameter
    count and its plain map ``fn(params, raw, degree)``."""

    fid: int
    kind: str
    n_params: int
    fn: Callable


TILE_TRANSFORMS = {
    "rbf": TileTransform(0, "sqdist", 1, rbf_tile),
    "matern12": TileTransform(1, "sqdist", 1, functools.partial(matern_tile, 1)),
    "matern32": TileTransform(2, "sqdist", 1, functools.partial(matern_tile, 3)),
    "matern52": TileTransform(3, "sqdist", 1, functools.partial(matern_tile, 5)),
    "rq": TileTransform(4, "sqdist", 2, rq_tile),
    "dot": TileTransform(5, "inner", 1, dot_tile),
    "poly": TileTransform(6, "inner", 1, poly_tile),
}


def matvec_tiles(s: int) -> int:
    """Row tiles one streamed product walks (the ``solver.matvec_tiles``
    metric): the CUDA kernel's blocks per expert."""
    return -(-int(s) // ROW_TILE)


def raw_tile(kind: str, xi, xj, si, sj, rows, cols):
    """One raw ``[..., ti, tj]`` tile: squared distances (clamped at 0,
    the diagonal pinned to 0) or inner products; ``rows`` / ``cols`` are
    the tile's global indices."""
    inner = xi @ xj.mT
    if kind == "inner":
        return inner
    raw = torch.clamp_min(si[..., :, None] + sj[..., None, :] - 2.0 * inner, 0.0)
    return torch.where(rows[:, None] == cols[None, :], 0.0, raw)


def streamed_matvec_plain(x, v, family: str, params, degree: int = 1,
                          tile: int = PLAIN_TILE):
    """``K(params) @ v`` in plain PyTorch: row panels times column tiles of
    ``tile`` rows, accumulated over the column tiles in order (the JAX
    package's scan).  ``x [..., s, p]``, ``v [..., s, n]`` or ``[..., s]``."""
    spec = TILE_TRANSFORMS[family]
    vec = v.ndim == x.ndim - 1
    v2 = v[..., None] if vec else v
    s = x.shape[-2]
    sqn = torch.sum(x * x, dim=-1)
    idx = torch.arange(s, device=x.device)
    panels = []
    for r0 in range(0, s, tile):
        r1 = min(r0 + tile, s)
        acc = None
        for c0 in range(0, s, tile):
            c1 = min(c0 + tile, s)
            raw = raw_tile(spec.kind, x[..., r0:r1, :], x[..., c0:c1, :],
                           sqn[..., r0:r1], sqn[..., c0:c1], idx[r0:r1], idx[c0:c1])
            term = spec.fn(params, raw, degree) @ v2[..., c0:c1, :]
            acc = term if acc is None else acc + term
        panels.append(acc)
    out = torch.cat(panels, dim=-2)
    return out[..., 0] if vec else out


def streamed_matvec_vjp_plain(x, w, v, family: str, params, degree: int = 1):
    """The theta-cotangent of ``sum(w * (K(params) @ v))`` by autograd
    through :func:`streamed_matvec_plain`: the plain counterpart of the
    VJP kernel."""
    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        out = streamed_matvec_plain(x, v, family, p, degree)
        (grad,) = torch.autograd.grad(torch.sum(w * out), p)
    return grad


def exps(e: int, s: int) -> int:
    """Special-function results (one ``exp`` a pair) of the least work of
    one K2 or K2-VJP launch on ``[e, s, p]``: each unordered off-diagonal
    pair once, since K is symmetric."""
    return e * s * (s - 1) // 2


def work(e: int, s: int, p: int, n: int, itemsize: int = 4):
    """``(flops, bytes)`` of one K2 launch on ``[e, s, p]`` rows and ``n``
    right-hand sides: the least work of the product, whatever design runs
    it.  Each unordered off-diagonal pair's distance and map once
    (``2p + 3`` flops, the RBF map's count, taken for every family) and the
    product over every ordered pair (``2n``); ``x`` and ``V`` read once,
    ``K V`` written once.  The ``exp``s are :func:`exps`."""
    return (float(exps(e, s) * (2 * p + 3) + e * s * s * 2 * n),
            float(itemsize * e * s * (p + 2 * n)))


def work_vjp(e: int, s: int, p: int, n: int, itemsize: int = 4):
    """``(flops, bytes)`` of one K2-VJP launch: per unordered off-diagonal
    pair (the RBF map's dk/dsigma is 0 at r = 0) the distance and the
    derivative (``2p + 6``), ``<W_i, V_j> + <W_j, V_i>`` (``4n``) and its
    product with dk (2); ``x``, ``W`` and ``V`` read once (the theta
    cotangent written is negligible and not counted)."""
    return float(exps(e, s) * (2 * p + 8 + 4 * n)), float(itemsize * e * s * (p + 2 * n))


def kernel_applies(x: torch.Tensor) -> bool:
    """A CUDA float32 row stack: the kernel takes any ``s``, ``p`` and ``n``
    (ragged tiles are bounds-checked), so no plain path remains on the card."""
    return x.is_cuda and x.dtype == torch.float32


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/streamed_matvec.cu``."""
    ints = [ctypes.c_int] * 6
    lib.streamed_matvec_f32.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
    lib.streamed_matvec_f32.restype = ctypes.c_int
    lib.streamed_matvec_vjp_f32.argtypes = [ctypes.c_void_p] * 6 + ints + [ctypes.c_void_p]
    lib.streamed_matvec_vjp_f32.restype = ctypes.c_int
    lib.streamed_matvec_vjp_blocks.argtypes = [ctypes.c_int] * 3
    lib.streamed_matvec_vjp_blocks.restype = ctypes.c_longlong
    lib.streamed_matvec_row_tile.argtypes = []
    lib.streamed_matvec_row_tile.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = bind(cuda_lib.load("streamed_matvec"))
    if lib.streamed_matvec_row_tile() != ROW_TILE:
        raise cuda_lib.KernelBuildError(
            "csrc/streamed_matvec.cu and ROW_TILE disagree on the row tile")
    return lib


def _check(x, tensors, params, spec):
    if not kernel_applies(x) or x.ndim != 3:
        raise ValueError(
            "streamed_matvec on the card takes a float32 [E, s, p] CUDA row "
            f"stack; got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype or t.shape[:2] != x.shape[:2]:
            raise ValueError(
                f"right-hand side {t.dtype} {tuple(t.shape)} on {t.device} does "
                f"not match the row stack {tuple(x.shape)}"
            )
    if params.device != x.device or params.dtype != x.dtype or params.numel() < spec.n_params:
        raise ValueError(
            f"params must be {spec.n_params} float32 values on {x.device}; "
            f"got {params.dtype} {tuple(params.shape)} on {params.device}"
        )


def _launch(x, v, params, spec, degree):
    """``K @ v`` by the forward kernel; ``x [E, s, p]``, ``v [E, s, n]``."""
    _check(x, (v,), params, spec)
    x, v, params = x.contiguous(), v.contiguous(), params.contiguous()
    batch, s, p = x.shape
    n = v.shape[-1]
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out.zero_()
    # scratch for the rows' squared norms, which the kernel's prologue fills
    sqn = torch.empty((batch, s), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().streamed_matvec_f32(
            x.data_ptr(), v.data_ptr(), params.data_ptr(), sqn.data_ptr(), out.data_ptr(),
            batch, s, p, n, spec.fid, int(degree),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise cuda_lib.KernelLaunchError(f"streamed_matvec kernel launch failed: CUDA error {err}")
    cuda_lib.record_launch(streamed_matvec, "streamed_matvec",
                           work(batch, s, p, n, x.element_size()))
    return out


def _launch_vjp(x, w, v, params, spec, degree):
    """The theta-cotangent of ``sum(w * (K @ v))`` by the VJP kernel."""
    _check(x, (w, v), params, spec)
    if w.shape != v.shape:
        raise ValueError(f"cotangent {tuple(w.shape)} and rhs {tuple(v.shape)} differ")
    x, w, v, params = x.contiguous(), w.contiguous(), v.contiguous(), params.contiguous()
    batch, s, p = x.shape
    n = v.shape[-1]
    grad = torch.zeros_like(params)
    if v.numel() == 0:
        return grad
    lib = _library()
    # scratch for the rows' squared norms, which the kernel's prologue fills
    sqn = torch.empty((batch, s), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        # one partial sum per block; the block count follows the card's SMs
        partial = torch.empty((lib.streamed_matvec_vjp_blocks(batch, s, n), 2),
                              dtype=x.dtype, device=x.device)
        err = lib.streamed_matvec_vjp_f32(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), params.data_ptr(), sqn.data_ptr(),
            partial.data_ptr(), batch, s, p, n, spec.fid, int(degree),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise cuda_lib.KernelLaunchError(
            f"streamed_matvec_vjp kernel launch failed: CUDA error {err}")
    cuda_lib.record_launch(streamed_matvec_vjp, "streamed_matvec_vjp",
                           work_vjp(batch, s, p, n, x.element_size()))
    total = partial.sum(dim=0, dtype=torch.float64).to(x.dtype)
    grad[: spec.n_params] = total[: spec.n_params]
    return grad


def streamed_matvec_vjp(x, w, v, family: str, params, degree: int = 1):
    """The theta-cotangent of ``sum(w * (K(params) @ v))`` over an
    ``[E, s, ...]`` stack: the VJP kernel on the card, autograd through the
    plain version on the CPU (which reports the kernel's work,
    ``obs/cost.py``)."""
    with obs_cost.library_paused():
        if x.device.type == "cpu":
            grad = streamed_matvec_vjp_plain(x, w, v, family, params, degree)
            e, s, p = x.shape
            cuda_lib.record_plain("streamed_matvec_vjp",
                                  work_vjp(e, s, p, v.shape[-1], x.element_size()))
            return grad
        return _launch_vjp(x, w, v, params, TILE_TRANSFORMS[family], degree)


class _StreamedMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v, params, family, degree):
        spec = TILE_TRANSFORMS[family]
        with obs_cost.library_paused():
            if x.device.type == "cpu":
                out = streamed_matvec_plain(x, v, family, params, degree)
                e, s, p = x.shape
                cuda_lib.record_plain("streamed_matvec",
                                      work(e, s, p, v.shape[-1], x.element_size()))
            else:
                out = _launch(x, v, params, spec, degree)
        ctx.family, ctx.degree = family, degree
        ctx.save_for_backward(x, v, params)
        return out

    @staticmethod
    def backward(ctx, g):
        x, v, params = ctx.saved_tensors
        g_v = g_params = None
        if ctx.needs_input_grad[1]:
            # K is symmetric: the cotangent of v is K @ g
            g_v = _StreamedMatvec.apply(x, g, params, ctx.family, ctx.degree)
        if ctx.needs_input_grad[2]:
            g_params = streamed_matvec_vjp(x, g, v, ctx.family, params, ctx.degree)
        return None, g_v, g_params, None, None


def streamed_matvec(x, v, family: str, params, degree: int = 1):
    """``K(params) @ v`` without materializing ``K``, differentiable in
    ``v`` and ``params``.

    ``x`` is the ``[..., s, p]`` row stack (leading dims are experts),
    ``v`` the ``[..., s, n]`` (or ``[..., s]``) right-hand side, ``family``
    a key of :data:`TILE_TRANSFORMS` and ``params`` its 1 or 2 parameters
    as a tensor on ``x``'s device (never read on the host); ``degree`` is
    the polynomial family's static power.  ``x`` must not require a
    gradient."""
    if family not in TILE_TRANSFORMS:
        raise ValueError(f"unknown tile transform {family!r}; use one of {sorted(TILE_TRANSFORMS)}")
    if x.requires_grad:
        raise ValueError("streamed_matvec does not differentiate the row stack x")
    vec = v.ndim == x.ndim - 1
    v2 = v[..., None] if vec else v
    lead = x.shape[:-2]
    xb = x.reshape((-1,) + tuple(x.shape[-2:]))
    vb = v2.reshape((-1,) + tuple(v2.shape[-2:]))
    out = _StreamedMatvec.apply(xb, vb, params, family, int(degree))
    out = out.reshape(tuple(lead) + tuple(out.shape[-2:]))
    return out[..., 0] if vec else out


#: kernel launches since the last reset (the wrappers' launch counters)
streamed_matvec.launches = 0
streamed_matvec_vjp.launches = 0
