"""Multi-process orchestration: the process group and the rank-local
expert stacks (the JAX package's ``parallel/distributed.py``).

The algorithm's collectives -- the (NLL, grad) sum of the BCM objective,
the (U1, u2) sum of the PPA statistics -- are the mesh's
(``parallel/mesh.py``).  This module is what surrounds them: bringing up
the process group, the mesh over its ranks, and assembling a rank's
block of a global expert stack from that rank's own rows.

Launch the same program once per rank, ``torchrun``-style (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` in the environment) or with
explicit arguments::

    from spark_gp_tpu_torch.parallel import distributed as dist

    dist.initialize()                        # or initialize("tcp://host:port", 2, rank)
    mesh = dist.global_expert_mesh()         # one rank = one device
    data = dist.distribute_global_experts(   # this rank's rows -> its block
        x_local, y_local, expert_size, mesh)
    model = GaussianProcessRegression().setMesh(mesh).fit_distributed(data)

One process alone needs none of it: :func:`initialize` is then a no-op
and the mesh has one rank.  :func:`initialize` builds the group's store
itself -- a ``FileStore`` for ``file://``, a ``TCPStore`` hosted by rank 0
for ``tcp://`` and ``env://`` -- and keeps it under the ``coord`` prefix
for ``parallel/coord.py``: the deadline-guarded barrier before every
blocking step here, liveness, the coordinated checkpoints, and the
key-value-store fit mode (``GP_DCN_MODE=1``: every cross-rank sum a
round over the store, no process-group collective in the fit).
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.parallel import coord
from spark_gp_tpu_torch.parallel.experts import ExpertData, group_for_experts
from spark_gp_tpu_torch.parallel.mesh import ExpertMesh, expert_mesh, shard_experts

#: the process-group timeout when the caller names none
DEFAULT_TIMEOUT_S = 300.0

_ENV_KEYS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

#: ``(PrefixStore("coord", store), rank, world size, host rank)`` of the
#: group :func:`initialize` brought up, or None
_COORD_STORE = None


def coord_store():
    """The coordination handle of the group :func:`initialize` brought up:
    ``(store, rank, world_size, host_rank)`` with the store under the
    ``coord`` prefix and ``host_rank`` the rank hosting a ``TCPStore``
    (None for a ``FileStore``); None without such a group."""
    import torch.distributed as dist

    if _COORD_STORE is None or not (dist.is_available() and dist.is_initialized()):
        return None
    return _COORD_STORE


def _make_store(init_method: str, world_size: int, rank: int, timeout):
    """``(store, host_rank)`` of ``init_method``: a ``FileStore`` for
    ``file://<path>``, a ``TCPStore`` that rank 0 hosts for
    ``tcp://<host>:<port>`` and ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``)."""
    from urllib.parse import urlparse

    import torch.distributed as dist

    url = urlparse(init_method)
    if url.scheme == "file":
        return dist.FileStore(url.path, int(world_size)), None
    if url.scheme == "tcp":
        host, port = url.hostname, url.port
    elif url.scheme == "env":
        host, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    else:
        raise ValueError(f"initialize takes file://, tcp:// or env://, got {init_method!r}")
    if host is None or port is None:
        raise ValueError(f"{init_method!r} names no host and port")
    return dist.TCPStore(host, int(port), int(world_size), int(rank) == 0,
                         timeout=timeout), 0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the default process group.

    A no-op when the group is already up, or when the process is alone:
    no arguments and none of ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK``
    in the environment.  With explicit arguments (``init_method`` such as
    ``"tcp://localhost:29500"`` or ``"file:///path"``, ``world_size``,
    ``rank``) or from the environment (``env://``), it joins the group;
    the backend is NCCL when the card is present and gloo otherwise,
    unless ``backend`` names one, and ``timeout_s`` bounds every wait of
    the group.  The store is built here and handed to the group, and kept
    for ``parallel/coord.py`` (:func:`coord_store`).  Under NCCL the rank's device is ``LOCAL_RANK`` (else the
    rank modulo the card count).

    A configuration that names several processes and cannot start
    raises: a rank that trained on its 1/P of the data alone would give
    wrong answers with no error.  Only an environment that names no more
    than one process degrades to running alone when the group cannot
    start, with a ``RuntimeWarning`` and the ``coord.degraded`` counter
    (the JAX package's rule)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    auto = init_method is None and world_size is None and rank is None
    if auto:
        if not any(k in os.environ for k in _ENV_KEYS):
            return  # one process: nothing to coordinate
        multi = _env_int("WORLD_SIZE", 1) > 1
        try:
            world_size = int(os.environ["WORLD_SIZE"])
            rank = int(os.environ["RANK"])
            if "MASTER_ADDR" not in os.environ:
                raise ValueError("MASTER_ADDR is not set")
        except (KeyError, ValueError) as exc:
            if multi:
                raise RuntimeError(
                    f"the environment names {os.environ.get('WORLD_SIZE')} processes but "
                    f"cannot start the process group: {exc!r}") from exc
            _degraded_to_single_process(type(exc).__name__, exc)
            return
        init_method = "env://"
    elif init_method is None or world_size is None or rank is None:
        raise ValueError("initialize needs init_method, world_size and rank together")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        local = _env_int("LOCAL_RANK", int(rank) % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    global _COORD_STORE
    timeout = datetime.timedelta(seconds=float(timeout_s))
    try:
        store, host_rank = _make_store(init_method, int(world_size), int(rank), timeout)
        coord.initialize_runtime(backend, store, int(world_size), int(rank), timeout, **kwargs)
    except (RuntimeError, ValueError, KeyError) as exc:
        if not auto or int(world_size) > 1:
            raise
        _degraded_to_single_process(type(exc).__name__, exc)
        return
    _COORD_STORE = (dist.PrefixStore("coord", store), int(rank), int(world_size), host_rank)
    coord.reset_runtime_state()


def _env_int(key: str, default: int) -> int:
    try:
        return int(os.environ[key])
    except (KeyError, ValueError):
        return default


def _degraded_to_single_process(reason: str, exc: BaseException) -> None:
    """The degrade is counted (``coord.degraded``) and stamped as a span
    event as well as warned: a warning that scrolls by is how a
    misconfigured cluster ships."""
    from spark_gp_tpu_torch.obs import trace as obs_trace
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc("coord.degraded")
    obs_trace.add_event("coord.degraded", reason=reason)
    warnings.warn(
        f"process group not started from the environment; continuing as one process: {exc}",
        RuntimeWarning, stacklevel=3)


def num_processes() -> int:
    """The world size of the default group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_expert_mesh(device=None) -> ExpertMesh:
    """The ``experts`` mesh over every rank of the default group (a mesh
    of this process alone without one)."""
    return expert_mesh(None, device)


def distribute_global_experts(x_local, y_local, dataset_size_for_expert: int,
                              mesh: Optional[ExpertMesh] = None, dtype=None,
                              device=None) -> ExpertData:
    """This rank's block of a global expert stack, from this rank's rows.

    Each rank groups its own ``[n_local, p]`` rows into experts (round
    robin, a different but equally balanced assignment than grouping all
    rows, with no exchange of rows), the ranks exchange their ``(E, s)``
    by one all-gather, and every rank pads its stack to the largest of
    each with masked entries (:func:`_pad_stack`), so the global stack is
    the ranks' blocks in rank order.  On ``device`` (default the mesh's)
    in ``dtype`` (default float32 on the card, float64 on the CPU).  One
    rank: :func:`~spark_gp_tpu_torch.parallel.mesh.shard_experts` of the
    grouped rows.

    Over several ranks a deadline-guarded barrier comes first
    (``coord.guard_collective("stitch")``), so a dead or wedged rank is
    named by a ``CoordinationTimeoutError`` instead of stalling the
    gather; under the key-value-store mode (``GP_DCN_MODE=1``) the dims
    travel by ``coord.kv_allgather`` instead of the group."""
    from spark_gp_tpu_torch.utils.device import working_dtype

    if mesh is None:
        mesh = global_expert_mesh(device)
    device = torch.device(device) if device is not None else mesh.device
    dtype = working_dtype(device) if dtype is None else dtype
    local = group_for_experts(x_local, y_local, dataset_size_for_expert)
    if mesh.world_size > 1:
        dims = np.asarray([local.num_experts, local.expert_size], dtype=np.int64)
        gathered = _exchange_dims(dims, mesh)
        e_max, s_max = (int(v) for v in gathered.max(axis=0))
        if (local.num_experts, local.expert_size) != (e_max, s_max):
            local = _pad_stack(local, e_max, s_max)
    out = ExpertData(x=local.x.to(device=device, dtype=dtype),
                     y=local.y.to(device=device, dtype=dtype),
                     mask=local.mask.to(device=device, dtype=dtype))
    return shard_experts(out, mesh) if mesh.world_size == 1 else out


_DIMS_ROUND = 0


def _exchange_dims(dims: np.ndarray, mesh: ExpertMesh) -> np.ndarray:
    """``[P, 2]`` every rank's ``(num_experts, expert_size)``, in rank
    order, after the guarded barrier: through the store under the
    key-value-store mode (every rank's k-th exchange is every peer's k-th,
    so the counter is the round's name), else one all-gather of the
    group."""
    global _DIMS_ROUND
    coord.guard_collective("stitch")
    client = coord.coord_client()
    if coord.dcn_context() is not None and client is not None:
        round_id, _DIMS_ROUND = _DIMS_ROUND, _DIMS_ROUND + 1
        payloads = coord.kv_allgather(f"dims/{round_id}", dims.tobytes(), client=client)
        if round_id >= 2:
            # the r-2 cleanup of DcnContext.allgather_bytes
            client.delete(f"ag/dims/{round_id - 2}/{client.process_id}")
        return np.stack([np.frombuffer(p, dtype=dims.dtype) for p in payloads])
    t = torch.as_tensor(dims, device=mesh.device)
    return torch.stack(mesh.all_gather(t)).cpu().numpy()


def _pad_stack(data: ExpertData, e_target: int, s_target: int) -> ExpertData:
    """The stack padded to ``[e_target, s_target, ...]`` with masked
    entries: each expert's new slots repeat its first point, new experts
    repeat expert 0, labels and mask are zero there (the JAX package's
    padding, value for value)."""
    x = data.x.cpu().numpy()
    y = data.y.cpu().numpy()
    mask = data.mask.cpu().numpy()
    e, s = x.shape[0], x.shape[1]
    if s_target > s:
        x = np.concatenate([x, np.repeat(x[:, :1], s_target - s, axis=1)], axis=1)
        y = np.pad(y, ((0, 0), (0, s_target - s)))
        mask = np.pad(mask, ((0, 0), (0, s_target - s)))
    if e_target > e:
        x = np.concatenate([x, np.repeat(x[:1], e_target - e, axis=0)], axis=0)
        y = np.pad(y, ((0, e_target - e), (0, 0)))
        mask = np.pad(mask, ((0, e_target - e), (0, 0)))
    return ExpertData(x=torch.as_tensor(x), y=torch.as_tensor(y), mask=torch.as_tensor(mask))


def replicated_valid_indices(data: ExpertData, mesh: Optional[ExpertMesh]) -> np.ndarray:
    """Global flat indices of the real (unpadded) rows of a rank-local
    stack, the same on every rank: the ranks' masks (N floats in all) are
    gathered in rank order, so the global order is the rank blocks'."""
    if mesh is None or mesh.world_size == 1:
        mask = data.mask.cpu().numpy()
    else:
        mask = torch.cat(mesh.all_gather(data.mask.contiguous())).cpu().numpy()
    return np.flatnonzero(mask.reshape(-1) > 0)


def sample_active_from_stack(data: ExpertData, m: int, seed: int,
                             mesh: Optional[ExpertMesh]) -> np.ndarray:
    """A uniform active set of ``m`` rows drawn off a rank-local stack,
    ``[m, p]`` float64, the same on every rank: every rank draws the same
    sorted global flat indices from the shared seed over
    :func:`replicated_valid_indices` (the JAX draw, index for index),
    fills the rows of its own block into a zero buffer, and one all-reduce
    assembles them; the traffic is the m rows, not the data.  ``mesh``
    None: the whole stack is here, and the rows are taken from it.  A
    store mesh (the key-value-store mode) draws the same rows by
    ``coord.sample_active_dcn``: the valid-row counts and then only the
    chosen rows cross the store."""
    if mesh is not None and mesh.ctx is not None:
        return coord.sample_active_dcn(mesh.ctx, data, m, seed)
    p = data.x.shape[-1]
    valid = replicated_valid_indices(data, mesh)
    m = min(int(m), valid.size)
    sel = np.sort(np.random.default_rng(seed).choice(valid, size=m, replace=False))
    xf = data.x.reshape(-1, p)
    if mesh is None or mesh.world_size == 1:
        return xf[torch.as_tensor(sel, device=xf.device)].to(torch.float64).cpu().numpy()
    n_local = xf.shape[0]
    lo = mesh.rank * n_local
    mine = (sel >= lo) & (sel < lo + n_local)
    out = torch.zeros((m, p), dtype=torch.float64, device=xf.device)
    rows = torch.as_tensor(np.flatnonzero(mine), device=xf.device)
    out[rows] = xf[torch.as_tensor(sel[mine] - lo, device=xf.device)].to(torch.float64)
    return mesh.all_reduce(out).cpu().numpy()
