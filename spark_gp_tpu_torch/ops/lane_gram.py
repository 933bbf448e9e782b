"""The gram stage of the mixed and fast precision lanes on TF32 tensor cores.

:func:`lane_gram` computes ``[..., n1, p] x [..., n2, p] -> [..., n1, n2]``
squared distances ``max(|x1|^2 + |x2|^2 - 2 <x1, x2>, 0)`` (with an exactly
zero diagonal for a self-gram), or the inner products alone, from float32
operands, in one of two modes (``ops/precision.py``):

* ``"tf32"``: one pass, ``<hi1, hi2>`` with ``hi`` the operand rounded to
  TF32 -- the fast lane (the JAX package's DEFAULT / HIGH contraction);
* ``"3xtf32"``: ``<hi1, hi2> + (<hi1, lo2> + <lo1, hi2>)`` with ``lo`` the
  TF32-rounded residual -- the mixed lane (the JAX package's split-bf16
  ``_inner_compensated``), which drops only ``<lo1, lo2>``.

* on a CUDA float32 tensor it launches ``csrc/lane_gram.cu`` (a 64 x 64
  output tile a block, ``mma.sync.m16n8k8`` TF32 tiles, the split done in
  registers, the norms, clamp and diagonal fused), which a CUDA graph can
  capture;
* on a CPU float32 tensor it runs :func:`lane_gram_plain`: the same
  arithmetic in float32 PyTorch, TF32 rounding emulated on the bit pattern
  and IEEE float32 matmuls of the exactly-representable parts;
* anything else on CUDA raises.

The gradient (to both operands; the ARD weights reach it through
``x * w``) is the IEEE float32 contraction of the cotangent with the
operands, as the JAX package differentiates its lanes' contractions
outside any kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.ops import cuda_lib

#: the kernel's modes (its ``mode`` argument)
MODES = {"tf32": 0, "3xtf32": 1}
_SELF, _INNER = 1, 2


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, nearest with ties away from zero
    (``cvt.rna.tf32.f32``): the low 13 mantissa bits of the magnitude
    rounded off on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: ``hi`` = ``x`` rounded to TF32, ``lo`` = the residual
    ``x - hi`` rounded to TF32."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def lane_inner_plain(x1: torch.Tensor, x2: torch.Tensor, mode: str) -> torch.Tensor:
    """``[..., n1, n2]`` inner products of the kernel's ``mode`` in float32
    PyTorch: every product of two TF32 values is exact in float32, so the
    float32 matmuls of the parts are the kernel's sums up to the order of
    accumulation."""
    if mode not in MODES:
        raise ValueError(f"lane_gram mode {mode!r}; expected one of {sorted(MODES)}")
    hi1, lo1 = split_tf32(x1)
    hi2, lo2 = split_tf32(x2)
    main = hi1 @ hi2.mT
    if mode == "tf32":
        return main
    return main + (hi1 @ lo2.mT + lo1 @ hi2.mT)


def zero_diag(d: torch.Tensor) -> torch.Tensor:
    """``d [..., n, n]`` with its diagonal set to 0 (a selection: no
    gradient flows through the diagonal)."""
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    return torch.where(eye, d.new_zeros(()), d)


def lane_gram_plain(x1, x2, mode: str, self_gram: bool = False, inner: bool = False):
    """The plain version of the kernel (module doc), float32 in and out."""
    dot = lane_inner_plain(x1, x2, mode)
    if inner:
        return dot
    n1 = torch.sum(x1 * x1, dim=-1)[..., :, None]
    n2 = torch.sum(x2 * x2, dim=-1)[..., None, :]
    d = torch.clamp_min(n1 + n2 - 2.0 * dot, 0.0)
    return zero_diag(d) if self_gram else d


#: TF32 tensor-core passes of each mode
PASSES = {"tf32": 1, "3xtf32": 3}


def work(b: int, n1: int, n2: int, p: int, mode: str, same_operand: bool = False,
         itemsize: int = 4):
    """``(flops, bytes)`` of one launch on ``b`` pairs of ``[n1, p]`` and
    ``[n2, p]`` operands: ``2 n1 n2 p`` flops a TF32 pass (:data:`PASSES`)
    and each operand read once (once in all where ``x1`` is ``x2``), the
    ``[n1, n2]`` output written once."""
    operands = b * n1 * p + (0 if same_operand else b * n2 * p)
    return (float(PASSES[mode] * 2 * b * n1 * n2 * p),
            float((operands + b * n1 * n2) * itemsize))


def _work_of(x1, x2, mode: str):
    """:func:`work` of one call on operands of one batch shape."""
    n1, p = x1.shape[-2], x1.shape[-1]
    b = x1.numel() // max(1, n1 * p)
    same = x1.data_ptr() == x2.data_ptr() and x1.shape == x2.shape
    return work(b, n1, x2.shape[-2], p, mode, same, x1.element_size())


def kernel_applies(x1: torch.Tensor, x2: torch.Tensor) -> bool:
    """Both operands CUDA float32 on one device, with matching features."""
    return (x1.is_cuda and x2.is_cuda and x1.device == x2.device
            and x1.dtype == torch.float32 and x2.dtype == torch.float32
            and x1.shape[-1] == x2.shape[-1])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point of a library built from ``csrc/lane_gram.cu``."""
    lib.lane_gram_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.lane_gram_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(cuda_lib.load("lane_gram"))


def _launch(x1, x2, mode: str, flags: int):
    """The kernel on operands of one batch shape (the wrapper broadcasts)."""
    if not kernel_applies(x1, x2) or mode not in MODES:
        raise ValueError(
            f"lane_gram on the card takes two float32 CUDA operands [..., n, p] on one "
            f"device and a mode in {sorted(MODES)}; got {x1.dtype} {tuple(x1.shape)} on "
            f"{x1.device}, {x2.dtype} {tuple(x2.shape)} on {x2.device}, mode {mode!r}")
    n1, p = x1.shape[-2], x1.shape[-1]
    n2 = x2.shape[-2]
    batch_shape = x1.shape[:-2]
    a = x1.reshape(-1, n1, p).contiguous()
    b = x2.reshape(-1, n2, p).contiguous()
    out = torch.empty(batch_shape + (n1, n2), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x1.device):
        err = _library().lane_gram_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                                       n1, n2, p, MODES[mode], flags,
                                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise cuda_lib.KernelLaunchError(f"lane_gram kernel launch failed: CUDA error {err}")
    cuda_lib.record_launch(lane_gram, "lane_gram", _work_of(x1, x2, mode))
    return out


def _forward(x1, x2, mode: str, flags: int):
    with obs_cost.library_paused():
        if x1.device.type == "cpu" and x2.device.type == "cpu":
            out = lane_gram_plain(x1, x2, mode, bool(flags & _SELF), bool(flags & _INNER))
            cuda_lib.record_plain("lane_gram", _work_of(x1, x2, mode))
            return out
        return _launch(x1, x2, mode, flags)


class _LaneGram(torch.autograd.Function):
    """The kernel (or its plain version) forward; the IEEE float32
    contraction backward."""

    @staticmethod
    def forward(ctx, x1, x2, mode, flags):
        out = _forward(x1, x2, mode, flags)
        ctx.flags = flags
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        if ctx.flags & _INNER:
            gx1 = g @ x2 if ctx.needs_input_grad[0] else None
            gx2 = g.mT @ x1 if ctx.needs_input_grad[1] else None
            return gx1, gx2, None, None
        # d out / d x1_i = 2 (x1_i - x2_j) where the clamp and the pinned
        # diagonal pass the value, else 0
        g = g * (out > 0).to(g.dtype)
        gx1 = gx2 = None
        if ctx.needs_input_grad[0]:
            gx1 = 2.0 * (g.sum(-1)[..., None] * x1 - g @ x2)
        if ctx.needs_input_grad[1]:
            gx2 = 2.0 * (g.sum(-2)[..., None] * x2 - g.mT @ x1)
        return gx1, gx2, None, None


def lane_gram(x1: torch.Tensor, x2: torch.Tensor, mode: str, self_gram: bool = False,
              inner: bool = False) -> torch.Tensor:
    """``[..., n1, n2]``: the squared distances (or with ``inner`` the
    inner products) of ``x1 [..., n1, p]`` and ``x2 [..., n2, p]`` in the
    lane ``mode`` (module doc); ``self_gram`` pins the diagonal of
    ``x1 == x2`` to 0.  Leading dimensions broadcast."""
    if x1.shape[:-2] != x2.shape[:-2]:
        lead = torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2])
        x1 = x1.expand(lead + x1.shape[-2:])
        x2 = x2.expand(lead + x2.shape[-2:])
    flags = (_SELF if self_gram else 0) | (_INNER if inner else 0)
    return _LaneGram.apply(x1, x2, mode, flags)


#: kernel launches since the last reset (the wrapper's launch counter)
lane_gram.launches = 0
