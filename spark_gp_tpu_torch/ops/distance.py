"""Pairwise squared distances and inner products, on the precision lanes.

``|x - y|^2 = |x|^2 + |y|^2 - 2 <x, y>``: the O(n^2 p) work is one
(batched) contraction of the feature axis.  The gram stage of the lane in
effect (``ops/precision.gram_mode``) picks it, as the JAX package's
``mxu_inner`` does:

* ``highest`` (the ``strict`` lane): an IEEE float32 matmul on the card
  (TF32 is off process-wide) or float64 on the CPU;
* ``compensated`` (the ``mixed`` lane) and ``high`` / ``default`` (the
  ``fast`` lane): the 3xTF32 and 1-pass TF32 modes of
  ``ops/lane_gram.py`` -- the hand-written tensor-core kernel on a CUDA
  tensor, its plain version on a CPU one.

float64 operands always take the IEEE path, so the float64 PPA statistics,
magic solve and predict are lane-immune, as the JAX package promises.
Distances are clamped at 0 and a self-distance diagonal is pinned to
exactly 0 on every lane.  Every function takes leading batch dimensions:
``[..., n1, p], [..., n2, p] -> [..., n1, n2]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_gp_tpu_torch.ops.lane_gram import lane_gram, zero_diag
from spark_gp_tpu_torch.ops.precision import gram_mode

#: the lane kernel's mode for each non-strict gram mode
_LANE_MODES = {"compensated": "3xtf32", "high": "tf32", "default": "tf32"}


def _lane_mode(x: torch.Tensor) -> Optional[str]:
    """The kernel mode a float32 operand takes on the lane in effect, or
    ``None`` for the IEEE path (strict, or a float64 operand)."""
    if x.dtype != torch.float32:
        return None
    return _LANE_MODES.get(gram_mode())


def mxu_inner(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise inner products ``<x1_i, x2_j>`` on the lane's gram stage:
    the dot-product families' grams and the periodic feature map's."""
    mode = _lane_mode(x1)
    if mode is None:
        return x1 @ x2.mT
    return lane_gram(x1, x2, mode, inner=True)


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, clamped at zero: the matmul identity can
    go slightly negative, which would poison ``exp`` kernels' gradients.
    ``torch.maximum`` splits the gradient at a tie like ``jnp.maximum``."""
    mode = _lane_mode(x1)
    if mode is not None:
        return lane_gram(x1, x2, mode)
    n1 = torch.sum(x1 * x1, dim=-1)[..., :, None]
    n2 = torch.sum(x2 * x2, dim=-1)[..., None, :]
    d = n1 + n2 - 2.0 * (x1 @ x2.mT)
    return torch.maximum(d, d.new_zeros(()))


def weighted_sq_dist(x1, x2, w) -> torch.Tensor:
    """Squared distances after scaling each feature by ``w`` (the ARD
    metric), by pre-scaling the rows."""
    return sq_dist(x1 * w, x2 * w)


def sq_dist_self(x: torch.Tensor) -> torch.Tensor:
    """``sq_dist(x, x)`` with the diagonal pinned to its analytic value 0
    (selection, so no gradient flows through the cancellation noise)."""
    mode = _lane_mode(x)
    if mode is not None:
        return lane_gram(x, x, mode, self_gram=True)
    return zero_diag(sq_dist(x, x))


def weighted_sq_dist_self(x: torch.Tensor, w) -> torch.Tensor:
    """ARD twin of :func:`sq_dist_self`.  The strict path scales each
    operand on its own (its gradient's float rounding depends on that);
    the lane kernel takes the scaled rows once, as a self-gram."""
    if _lane_mode(x) is not None:
        return sq_dist_self(x * w)
    return zero_diag(weighted_sq_dist(x, x, w))
