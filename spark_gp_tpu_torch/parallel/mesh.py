"""The expert mesh: the expert axis split over the ranks of a
``torch.distributed`` process group (the JAX package's
``parallel/mesh.py``).

The reference's parallelism is data parallelism over experts with an
all-reduce, plus a broadcast.  The JAX package maps it onto a 1-D device
mesh that one process drives: the ``[E, ...]`` stack is sharded on the
``experts`` axis and ``psum`` sums over it inside ``shard_map``.  PyTorch
runs one process per device instead, so here the mesh is a process group
and this rank's device, and every rank runs the same program (SPMD):

* Spark executors          -> the ranks of the group, one device each
* RDD of experts           -> this rank's contiguous block of the
  ``[E, ...]`` stack (:func:`shard_experts`)
* ``treeAggregate``        -> :meth:`ExpertMesh.all_reduce`, one SUM
* ``broadcast(activeSet)`` -> every rank computes the same replicated
  values from the same inputs (the active set, theta, the magic solve)

A mesh of one rank needs no process group: its collectives are the
identity, so ``setMesh(expert_mesh())`` in a single process runs the
sharded code paths on the whole stack.

**Backends.**  The collectives take the payload where it lives, on the
card or the host, under either backend: NCCL works on the card's
tensors, and gloo takes the card's tensors for ``all_reduce`` and
``all_gather`` as well as the host's (it copies them through host memory
itself; both checked on torch 2.11 on the H100).  What follows the
backend's name is the capture rule (:attr:`ExpertMesh.capturable`): a
CUDA graph can hold an NCCL collective once its communicator exists,
while a gloo collective synchronizes with the host, so a device fit on
the card over a gloo group raises :class:`MeshCaptureError` before it
captures anything.  The third backend, ``"store"``, is the key-value-store
fit mode (``GP_DCN_MODE=1``, ``parallel/coord.py``): the same ranks with
every collective a deadline-guarded, attested round over the group's
store, host work that the fit runs on the host optimizer.  What stands
around the collectives -- barriers before a blocking step, liveness,
coordinated checkpoints -- is ``parallel/coord.py``'s.

The payloads are small: ``h + 1`` scalars an objective evaluation (the
ELBO's ``m^2 + m + 3`` sums and then ``h``), the ``[m, m]`` float64
``U1`` once a fit, and from 2,048 active points the row-sharded magic
solve's ``[m, b]`` panels (``ops/dist_linalg.py``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

EXPERT_AXIS = "experts"


class MeshCaptureError(RuntimeError):
    """A sharded device fit on the card whose group's collectives cannot be
    captured into a CUDA graph (a gloo collective synchronizes with the
    host); run it under NCCL, or on the host optimizer."""


@dataclass(frozen=True)
class ExpertMesh:
    """A 1-D ``experts`` mesh: the process group (``None`` for a mesh of one
    rank without one), this rank, the world size, this rank's device and
    the group's backend (``"nccl"``, ``"gloo"``, or ``"none"`` without a
    group).  A mesh with ``backend="store"`` has no group: its ``ctx`` is a
    key-value-store fit context (``parallel/coord.store_mesh``) and every
    collective is a round over the store, summed in float64 in rank order,
    so the result is the same bits on every rank."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device
    backend: str
    ctx: Optional[object] = None

    @property
    def capturable(self) -> bool:
        """Whether the collectives can run inside a captured CUDA graph:
        NCCL's can, and a mesh without a group has none to capture (a store
        round is host work, never captured)."""
        return self.backend in ("nccl", "none")

    def _store_reduce(self, a: np.ndarray, op: str, name: str) -> np.ndarray:
        """``a`` reduced over the ranks through the store context."""
        if op == "sum":
            return self.ctx.allreduce_arrays(name, a)[0]
        parts = [p[0] for p in self.ctx.allgather_arrays(f"{name}_{op}", a)]
        fold = np.maximum if op == "max" else np.minimum
        out = parts[0]
        for part in parts[1:]:
            out = fold(out, part)
        return out

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``tensor`` reduced over the ranks (``op``: ``"sum"``, ``"max"``
        or ``"min"``), as a new tensor on ``tensor``'s device; every rank
        gets the same result.  Not differentiable: callers reduce
        detached values and gradients (a differentiable all-reduce would
        sum the replicated theta's upstream gradient again in its
        backward, multiplying it by the world size)."""
        if self.ctx is not None:
            a = tensor.detach().to(torch.float64).cpu().numpy()
            return torch.as_tensor(self._store_reduce(a, op, "mesh/all_reduce"),
                                   dtype=tensor.dtype, device=tensor.device)
        if self.group is None:
            return tensor.clone()
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        out = tensor.detach().clone()
        dist.all_reduce(out, op=red, group=self.group)
        return out

    def all_reduce_host(self, array, op: str = "sum") -> np.ndarray:
        """A host array reduced over the ranks, in float64: through the
        card under NCCL (which takes no host tensor), on the host under
        gloo."""
        a = np.asarray(array, dtype=np.float64)
        if self.ctx is not None:
            return self._store_reduce(a, op, "mesh/all_reduce_host")
        if self.group is None:
            return a.copy()
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.as_tensor(a, device=dev)
        return self.all_reduce(t, op).cpu().numpy()

    def all_gather(self, tensor: torch.Tensor) -> list:
        """Every rank's ``tensor`` (the same shape on every rank), in rank
        order, on ``tensor``'s device."""
        if self.ctx is not None:
            parts = self.ctx.allgather_arrays("mesh/all_gather", tensor.detach().cpu().numpy())
            return [torch.as_tensor(p[0], dtype=tensor.dtype, device=tensor.device)
                    for p in parts]
        if self.group is None:
            return [tensor.clone()]
        import torch.distributed as dist

        src = tensor.detach().contiguous()
        outs = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(outs, src, group=self.group)
        return outs


def expert_mesh(group=None, device=None) -> ExpertMesh:
    """The ``experts`` mesh over ``group`` (default: the default process
    group when one is up, else a mesh of this process alone) with this
    rank's ``device``: the port's rule whatever the backend, the card
    unless the caller passes ``device="cpu"``, and an error without one
    (``utils/device.resolve_device``).  The default card is
    ``cuda:<LOCAL_RANK>`` when the environment names the local rank (modulo
    the card count, as :func:`~spark_gp_tpu_torch.parallel.distributed.initialize`
    picks it), else the current device."""
    import torch.distributed as dist

    device = _rank_device(device)
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return ExpertMesh(None, 0, 1, device, "none")
    group = group if group is not None else dist.group.WORLD
    backend = str(dist.get_backend(group)).lower()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    return ExpertMesh(group, int(rank), int(world), device, backend)


def _rank_device(device) -> torch.device:
    from spark_gp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = int(local) % torch.cuda.device_count() if local is not None \
            else torch.cuda.current_device()
        dev = torch.device("cuda", index)
    return dev


def shard_experts(data, mesh: ExpertMesh):
    """This rank's block of the full stack ``data``: the expert axis padded
    to a multiple of the world size (``ExpertData.pad_experts``: masked
    copies of expert 0), then split into contiguous blocks in rank order,
    as the JAX package places the axis on its devices."""
    from spark_gp_tpu_torch.parallel.experts import ExpertData

    data = data.pad_experts(mesh.world_size)
    per = data.num_experts // mesh.world_size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return ExpertData(x=data.x[sl], y=data.y[sl], mask=data.mask[sl])


def padded_experts(num_experts: int, mesh: ExpertMesh) -> int:
    """The global expert count after :func:`shard_experts`'s padding."""
    return math.ceil(num_experts / mesh.world_size) * mesh.world_size


def shard_rows(values, mesh: ExpertMesh, fill=0):
    """This rank's block of a per-expert ``[E, ...]`` numpy array (padded
    with ``fill`` as the stack is): a data screen's bad-expert flags, a
    weight vector."""
    values = np.asarray(values)
    target = padded_experts(values.shape[0], mesh)
    if target > values.shape[0]:
        pad = np.full((target - values.shape[0],) + values.shape[1:], fill, dtype=values.dtype)
        values = np.concatenate([values, pad])
    per = target // mesh.world_size
    return values[mesh.rank * per:(mesh.rank + 1) * per]


def replicated(a, mesh: ExpertMesh) -> torch.Tensor:
    """``a`` on this rank's device, the same on every rank (the
    ``broadcast``: every rank holds the m active points and the m x m
    factors)."""
    return torch.as_tensor(a, device=mesh.device)


def mesh_shape(mesh) -> Optional[list]:
    """JSON-able ``[["experts", world_size]]`` topology of a mesh, or None
    (the form a checkpoint's elastic-resume stamp records)."""
    if mesh is None:
        return None
    return [[EXPERT_AXIS, int(mesh.world_size)]]


def sharded_cache_operand(cache, mesh: ExpertMesh):
    """This rank's block of a theta-invariant gram cache built over the full
    stack (``kernels/base.py``: every leaf has the expert axis first), or
    None.  A cache built from a rank-local stack is already its block."""
    if cache is None:
        return None
    return _map_leaves(cache, lambda a: shard_rows_tensor(a, mesh))


def sharded_weights_operand(weights, mesh: ExpertMesh):
    """This rank's block of the ``[E]`` aggregation weights (padded experts
    weigh 0), or None: each rank's weighted partial sum then all-reduces
    to the global ``sum_e w_e NLL_e``."""
    if weights is None:
        return None
    if isinstance(weights, torch.Tensor):
        return shard_rows_tensor(weights, mesh)
    return shard_rows(np.asarray(weights, dtype=np.float64), mesh)


def shard_rows_tensor(a: torch.Tensor, mesh: ExpertMesh) -> torch.Tensor:
    """:func:`shard_rows` of a tensor (zeros pad it)."""
    target = padded_experts(a.shape[0], mesh)
    if target > a.shape[0]:
        a = torch.cat([a, a.new_zeros((target - a.shape[0],) + tuple(a.shape[1:]))])
    per = target // mesh.world_size
    return a[mesh.rank * per:(mesh.rank + 1) * per]


def _map_leaves(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(t, fn) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return tree


def allreduced_objective(objective, mesh: ExpertMesh):
    """A host objective ``(theta, *carry) -> (value, grad, *carry_new)``
    summed over the ranks: each rank evaluates its own experts (its carry,
    the latent modes or sites, stays local), then the value and gradient
    are all-reduced in float64 in one collective.  The gradient is the
    local autograd (or hand-assembled) one, reduced once -- never through
    a differentiable collective."""

    if mesh.ctx is not None:
        # the store mode: the vag round, with the preemption flag and the
        # spot checks (parallel/coord.DcnContext.wrap_value_and_grad)
        return mesh.ctx.wrap_value_and_grad(objective)

    def reduced(theta, *carry):
        value, grad, *rest = objective(theta, *carry)
        flat = mesh.all_reduce_host(np.concatenate([[value], np.asarray(grad).ravel()]))
        return (float(flat[0]), flat[1:].reshape(np.shape(grad)), *rest)

    return reduced


def allreduced_lanes(vag, mesh: ExpertMesh):
    """The device optimizer's lanes objective ``thetas [R, h] -> (values
    [R], grads [R, h])`` summed over the ranks on the device: one
    all-reduce of ``[R, 1 + h]`` an evaluation, which a CUDA graph holds
    under NCCL."""

    def reduced(thetas):
        values, grads = vag(thetas)
        flat = mesh.all_reduce(torch.cat([values[:, None], grads], dim=1))
        return flat[:, 0], flat[:, 1:]

    return reduced
