"""Round-robin expert grouping as a gather + pad.

Point ``i`` belongs to expert ``i % E`` with ``E = round(N / s)``; each
expert is padded to the common width ``ceil(N / E)`` with copies of its
first point, and a 0/1 mask keeps the padding out of every reduction.
The layout is built in host numpy exactly as the JAX package builds it, so
the stack and mask are bit-identical, then moved to the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ExpertData:
    """Dense expert stack: ``x [E, s, p]``, ``y [E, s]`` (zero-padded) and
    ``mask [E, s]`` (1.0 real, 0.0 padding), all on one device."""

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor

    @property
    def num_experts(self) -> int:
        return self.x.shape[0]

    @property
    def expert_size(self) -> int:
        return self.x.shape[1]

    def with_experts_masked(self, drop, benign_row=None) -> "ExpertData":
        """The stack with the ``drop``-flagged experts made inert (the
        quarantine primitive, ``resilience/quarantine.py``): mask and
        labels zeroed, so the masked gram embedding turns each dropped
        expert into an identity block that adds exactly 0 to every
        reduction, and features replaced by ``benign_row`` (default: the
        first kept expert's first point), because a fully masked expert
        still flows through ``kernel.gram`` and ``0 * NaN`` would
        re-poison the sum.  Shapes are unchanged."""
        drop = np.asarray(drop, dtype=bool)
        if not drop.any():
            return self
        drop_dev = torch.as_tensor(drop, device=self.x.device)
        if benign_row is None:
            benign_row = self.x[int(np.argmax(~drop)), :1]  # [1, p]
        x = torch.where(drop_dev[:, None, None], benign_row[None], self.x)
        # zero by selection, never by multiplication: a dropped expert's
        # labels may be NaN or inf, and 0 * NaN = NaN
        y = torch.where(drop_dev.reshape((-1,) + (1,) * (self.y.ndim - 1)),
                        torch.zeros((), dtype=self.y.dtype, device=self.y.device), self.y)
        keep = (~drop_dev).to(self.mask.dtype)
        return ExpertData(x=x, y=y, mask=self.mask * keep[:, None])

    def pad_experts(self, multiple: int) -> "ExpertData":
        """The expert axis padded up to a multiple of ``multiple`` (even
        shards over a mesh): padded experts are copies of expert 0 with
        zero labels and a zero mask, so they add nothing."""
        e = self.num_experts
        pad = math.ceil(e / multiple) * multiple - e
        if pad == 0:
            return self
        x = torch.cat([self.x, self.x[:1].repeat((pad,) + (1,) * (self.x.ndim - 1))])
        y = torch.cat([self.y, torch.zeros_like(self.y[:1]).repeat(
            (pad,) + (1,) * (self.y.ndim - 1))])
        mask = torch.cat([self.mask, torch.zeros_like(self.mask[:1]).repeat(pad, 1)])
        return ExpertData(x=x, y=y, mask=mask)


def num_experts_for(n_points: int, dataset_size_for_expert: int) -> int:
    """E = round(N / s) (half-up), at least 1."""
    return max(1, int(math.floor(n_points / dataset_size_for_expert + 0.5)))


def group_for_experts(x, y, dataset_size_for_expert: int, dtype=None,
                      device="cpu") -> ExpertData:
    """Group ``(x [N, p], y [N])`` into the ``[E, s, ...]`` expert stack on
    ``device`` (``dtype`` defaults to the input's)."""
    x = np.asarray(x)
    y = np.asarray(y)
    n = x.shape[0]
    e = num_experts_for(n, dataset_size_for_expert)
    s = math.ceil(n / e)

    # expert j, slot t holds point j + t*e (when < n); padded slots gather
    # the expert's first point
    point = np.arange(e)[:, None] + np.arange(s)[None, :] * e  # [e, s]
    valid = point < n
    gather = np.where(valid, point, np.arange(e)[:, None])

    xg = x[gather]
    yg = np.where(valid, y[gather], 0.0).astype(y.dtype)
    mask = valid.astype(x.dtype)

    def put(a):
        t = torch.as_tensor(a)
        return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)

    return ExpertData(x=put(xg), y=put(yg), mask=put(mask))


def ungroup(values, n_points: int) -> np.ndarray:
    """Invert the round-robin grouping: ``[E, s] -> [N]`` in point order."""
    values = np.asarray(values)
    e, s = values.shape
    point = np.arange(e)[:, None] + np.arange(s)[None, :] * e
    valid = point < n_points
    out = np.zeros(n_points, dtype=values.dtype)
    out[point[valid]] = values[valid]
    return out
