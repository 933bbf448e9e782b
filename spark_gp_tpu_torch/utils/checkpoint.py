"""Preemption-safe checkpoints of the L-BFGS-B optimizers (the JAX
package's ``utils/checkpoint.py``).

:class:`LbfgsCheckpointer` is the optimizer's per-iteration callback: it
saves theta, the iteration count and the estimator seed as one JSON
payload (the JAX package's keys), plus the log of every objective
evaluation so far (``evaluations``: theta, value, gradient) and the
kernel and data fingerprints that tie the log to its fit.  The
structural signature ``kernel_sig`` is the JAX package's
(``kernel.describe`` at a zero theta), so a host checkpoint written by
either package resumes in the other.
``setCheckpointDir`` installs it, and a refit of the same kernel on the
same data resumes
(``models/common.GaussianProcessCommons._optimize_hypers_body``): SciPy's
L-BFGS-B keeps its curvature pairs to itself, so the port restarts it
from the initial theta and answers its evaluations from the log, which
rebuilds the optimizer's state exactly at no objective cost; from the
preempted iteration on the fit runs live and retraces the uninterrupted
one.  A payload without the log resumes as the JAX package's does, from
the saved theta with the remaining iteration budget.

:class:`DeviceOptimizerCheckpointer` is the device optimizer's segment
saver (``optimize/lbfgs_device.py``): between segments it writes one
lane's full ``_LbfgsState`` -- iterate, gradient, curvature history,
counters and flags -- in the JAX package's ``.npz`` layout (``leaf_i``
arrays in the state's field order, ``meta_json`` and a sha256
``checksum``), so a device checkpoint moves between the two packages.
:func:`run_segmented` is the segment loop, and :func:`segment_meta` the
resume guard both packages write: a checkpoint whose meta differs (other
objective, kernel spec, tol, parameterization, start, stack shape or
data) is ignored with a warning.  Saves fall on iteration boundaries,
so a payload never holds a half-finished line search.

Under a mesh both writers sit in the coordinated shells of
``parallel/coord.py`` (rank 0 writes, every rank checks the digest of the
payload it would have written: hence :meth:`LbfgsCheckpointer.build_payload`
/ ``write_payload`` and :meth:`DeviceOptimizerCheckpointer.build_arrays` /
``write_arrays``), and both payloads carry the JAX package's ``elastic``
stamp (``coord.elastic_meta``): a checkpoint written by P ranks resumes on
P' ranks -- counted as ``coord.elastic_resumes`` -- while a stamped device
payload of a P > 1 fit whose identity differs raises
:class:`ElasticResumeError` instead of being ignored.  A save boundary
acts on a preemption signal (``coord.preemption_watch``): the fit stops
there with ``coord.PreemptedError``, the checkpoint complete.

Durability: the payload is written to ``<path>.tmp``, fsynced and
``os.replace``d over the file, so a kill at any instant leaves the
previous complete checkpoint or the new one, never a torn file.  Each
payload carries a sha256 over its own canonical JSON; a checkpoint that
fails it raises :class:`CheckpointCorruptError`, and one written under
another kernel configuration :class:`CheckpointMismatchError`.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Optional

import numpy as np


class CheckpointMismatchError(RuntimeError):
    """The checkpoint on disk belongs to another configuration (kernel
    signature or theta shape) than the fit resuming from it.  Clear the
    checkpoint directory or use one per configuration."""


class CheckpointCorruptError(RuntimeError):
    """The checkpoint (or a model artifact) failed its content checksum:
    corruption on disk, since the atomic write rules out torn files.
    Delete the file to restart the fit from scratch."""


class ElasticResumeError(RuntimeError):
    """A coordinated checkpoint of a multi-rank fit cannot resume under the
    current configuration: its identity (kernel, objective, data, stack
    shapes) differs from the fit resuming.  A different PROCESS COUNT is
    fine (theta is replicated and the stack re-shards); a different fit is
    not, and silently restarting would discard the work without a trace."""


def _raise_if_preempted() -> None:
    """The save boundary's preemption hook (``parallel/coord.py``): when a
    SIGTERM landed (or one is staged), the save that just completed is
    the final one -- stop here with ``coord.PreemptedError``.  The
    telemetry record happens here, never in the signal handler."""
    from spark_gp_tpu_torch.parallel import coord

    if coord.preemption_requested():
        coord.note_preemption_observed()
        coord.consume_preemption()  # acted on: must not poison later fits
        raise coord.PreemptedError(
            "preemption signalled: the checkpoint just written is the final coordinated "
            "save -- resume after rescheduling")


def note_elastic_resume(stored_process_count, current_process_count) -> None:
    """Count one elastic resume (``coord.elastic_resumes``) and mark it with
    a span event."""
    from spark_gp_tpu_torch.obs import trace as obs_trace
    from spark_gp_tpu_torch.obs.runtime import telemetry

    telemetry.inc("coord.elastic_resumes")
    obs_trace.add_event("coord.elastic_resume", stored_process_count=stored_process_count,
                        current_process_count=current_process_count)


def fingerprints_match(a, b, rtol: float = 0.0) -> bool:
    """Two :func:`data_fingerprint` lists equal, or equal to ``rtol`` where
    the two sides summed in different orders (the two packages, or a stack
    summed on P ranks against P' ranks)."""
    if a is None or b is None:
        return a is None and b is None
    if len(a) != len(b):
        return False
    return all(abs(u - v) <= rtol * max(1.0, abs(u), abs(v)) for u, v in zip(a, b))


#: the tolerance of a fingerprint summed in another order
SUMMATION_RTOL = 1e-9


def _fsync_replace(tmp: str, path: str) -> None:
    """Flush ``tmp`` to stable storage, rename it atomically over ``path``
    and fsync the directory entry."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync; the rename is atomic
    finally:
        os.close(dir_fd)


def _payload_checksum(payload: dict) -> str:
    """sha256 over the canonical JSON of everything but the checksum."""
    body = {k: v for k, v in payload.items() if k != "checksum"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def kernel_signature(kernel, theta_dim: int) -> str:
    """Structural identity of a kernel configuration, the JAX package's:
    ``kernel.describe`` at a zero theta (no values), so that a checkpoint
    is not resumed under another kernel that happens to share
    ``theta_dim``, and a checkpoint written by either package is checked
    by the other the same way."""
    return kernel.describe(np.zeros(int(theta_dim)))


def kernel_fingerprint(kernel) -> str:
    """Process-stable full identity of a kernel spec: the class tree plus
    every constant of its state (initial values, bounds, static shapes),
    rendered recursively; stronger than :func:`kernel_signature`."""

    def value(v) -> str:
        if hasattr(v, "n_hypers") and hasattr(v, "init_theta"):
            return render(v)
        if isinstance(v, np.ndarray):
            return repr(tuple(v.ravel().tolist())) + repr(v.shape)
        if isinstance(v, (tuple, list)):
            return "(" + ",".join(value(s) for s in v) + ")"
        if callable(v) or v is None:
            return "-" if v is None else "fn"
        return repr(v)

    def render(k) -> str:
        state = ",".join(f"{key}={value(v)}" for key, v in sorted(vars(k).items()))
        return f"{type(k).__name__}({state})"

    return render(kernel)


def data_fingerprint(*arrays) -> list:
    """Cheap content fingerprint of arrays (float64 sum and sum of squares
    of each): the same data reproduces it, different data almost surely
    does not."""
    vals = []
    for a in arrays:
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        a64 = np.asarray(a, dtype=np.float64)
        vals.extend([float(np.sum(a64)), float(np.sum(a64 * a64))])
    return vals


def stack_fingerprint(x, y, mask, mesh=None):
    """``(fingerprint, experts)`` of an expert stack: the
    :func:`data_fingerprint` of ``(x, y, mask)`` and the count of its
    experts, both over the experts that hold a point.  An expert whose
    mask is all zero -- the padding ``parallel/mesh.shard_experts`` and
    ``distribute_global_experts`` add to even out the ranks -- is left
    out, so the stack fitted on P ranks and on P' ranks gives the same
    values up to summation order.  For a stack without such experts these
    are the JAX package's ``data_fingerprint(x, y, mask)`` and
    ``x.shape[0]``.  Under a ``mesh`` of several ranks the stack is this
    rank's block, and both are the whole stack's (summed over the
    ranks)."""
    x, y, mask = _as_numpy(x), _as_numpy(y), _as_numpy(mask)
    keep = mask.reshape(mask.shape[0], -1).any(axis=1)
    values = data_fingerprint(x[keep], y[keep], mask[keep]) + [float(keep.sum())]
    if mesh is not None and int(mesh.world_size) > 1:
        values = [float(v) for v in mesh.all_reduce_host(values)]
    return values[:-1], int(round(values[-1]))


class LbfgsCheckpointer:
    """Host L-BFGS-B callback that saves the optimizer's state each
    iteration.

    ``tag`` (the estimator's class name, plus the objective) keys the file,
    so fits of different families or objectives sharing a directory do
    not meet.  The payload: theta, the iteration count (the resume budget),
    the seed, the evaluation log, what ties the log to its fit (the
    kernel's :func:`kernel_fingerprint` and ``data``, the
    :func:`data_fingerprint` of the fitted stack) and ``elastic``, the
    multi-rank stamp (``coord.elastic_meta``) when given."""

    def __init__(self, directory: str, kernel, tag: str = "gp",
                 seed: Optional[int] = None, data: Optional[list] = None,
                 elastic: Optional[dict] = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"lbfgs_state_{tag}.json")
        self.kernel = kernel
        self.seed = seed
        self.data = data
        self.elastic = elastic
        self.iteration = 0
        #: every objective evaluation so far: [theta, value, gradient]
        self.evaluations: list = []

    def record(self, theta, value, grad) -> None:
        """Log one objective evaluation (the optimizer calls this for each,
        replayed or live)."""
        self.evaluations.append([np.asarray(theta, dtype=np.float64).tolist(), float(value),
                                 np.asarray(grad, dtype=np.float64).tolist()])

    def build_payload(self, theta) -> dict:
        """Advance the iteration state and render the payload (apart from
        the write, so the coordinated shell can check the digest every rank
        would have written before rank 0 writes it)."""
        theta = np.asarray(theta, dtype=np.float64)
        self.iteration += 1
        payload = {
            "format_version": 2,
            "iteration": self.iteration,
            "theta": theta.tolist(),
            "seed": self.seed,
            "kernel": self.kernel.describe(theta),
            "kernel_sig": kernel_signature(self.kernel, theta.shape[0]),
            "kernel_fingerprint": kernel_fingerprint(self.kernel),
            "data_fingerprint": self.data,
            "evaluations": list(self.evaluations),
        }
        if self.elastic is not None:
            payload["elastic"] = self.elastic
        payload["checksum"] = _payload_checksum(payload)
        return payload

    def write_payload(self, payload: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
            fh.flush()
        _fsync_replace(tmp, self.path)

    def __call__(self, theta) -> None:
        from spark_gp_tpu_torch.resilience import chaos

        self.write_payload(self.build_payload(theta))
        # tick AFTER the write (as run_segmented): "kill after N save
        # boundaries" leaves N complete saves on disk
        chaos.tick_kill_counter()
        _raise_if_preempted()


def payload_state(payload: dict):
    """``(iteration, theta, kernel_sig)`` of a checkpoint payload."""
    return (
        payload["iteration"],
        np.asarray(payload["theta"], dtype=np.float64),
        payload.get("kernel_sig"),
    )


def load_checkpoint(directory: str, tag: str = "gp"):
    """``(iteration, theta, kernel_sig)``, or ``None`` when there is no
    checkpoint; raises :class:`CheckpointCorruptError` on a checksum
    failure."""
    payload = load_checkpoint_payload(directory, tag)
    return None if payload is None else payload_state(payload)


def load_checkpoint_payload(directory: str, tag: str = "gp"):
    """The checksum-verified payload dict, or ``None`` when absent."""
    path = os.path.join(directory, f"lbfgs_state_{tag}.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        try:
            payload = json.load(fh)
        except ValueError as exc:
            raise CheckpointCorruptError(f"checkpoint {path} is not valid JSON: {exc}") from exc
    stored = payload.get("checksum")
    if stored is not None and stored != _payload_checksum(payload):
        raise CheckpointCorruptError(
            f"checkpoint {path} failed its content checksum; delete it to "
            "restart the fit from scratch"
        )
    return payload


# --- the device optimizer's checkpoints ---------------------------------------


def _npz_digest(arrays) -> str:
    """sha256 over the sorted ``name -> array`` entries but ``checksum``
    (the JAX package's device-checkpoint digest)."""
    digest = hashlib.sha256()
    for key in sorted(k for k in arrays if k != "checksum"):
        digest.update(key.encode())
        digest.update(np.ascontiguousarray(arrays[key]).tobytes())
    return digest.hexdigest()


def spec_fingerprint(kernel) -> str:
    """The JAX package's device-checkpoint kernel fingerprint: the class
    tree with every spec constant (``Kernel._spec``, which the port's
    kernels mirror), so a checkpoint written by either package names the
    same kernel the same way."""

    def render(v) -> str:
        if hasattr(v, "_spec") and hasattr(v, "init_theta"):
            return f"{type(v).__name__}({','.join(render(c) for c in v._spec())})"
        if isinstance(v, tuple):
            return "(" + ",".join(render(c) for c in v) + ")"
        return repr(v)

    return render(kernel)


def _as_numpy(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def segment_meta(kind, kernel, tol, log_space, theta0, x, y, mask, mesh=None,
                 **extra) -> dict:
    """The segmented fit's resume guard, as the JAX package writes it:
    everything that must match for a stored state to resume -- the
    objective family, the kernel spec, tol, the parameterization, the
    starting point, the stack's shape and a content fingerprint of its
    data (:func:`stack_fingerprint`: the experts that hold a point, so the
    padding that evens out the ranks does not count).  Under a ``mesh`` of
    several ranks ``x``, ``y``, ``mask`` are this rank's block and the meta
    is the whole stack's, so every rank's payload is the same."""
    theta0 = _as_numpy(theta0)
    fingerprint, experts = stack_fingerprint(x, y, mask, mesh)
    meta = {
        "kind": str(kind),
        "kernel": spec_fingerprint(kernel),
        "tol": float(tol),
        "log_space": bool(log_space),
        "theta0": [float(v) for v in theta0.ravel()],
        "theta_dim": int(theta0.shape[0]),
        "num_experts": experts,
        "expert_size": int(x.shape[1]),
        "data_fingerprint": fingerprint,
    }
    meta.update(extra)
    return meta


def _meta_matches(stored: dict, want: dict) -> bool:
    """Equal metas, the data fingerprints to summation-order rounding (the
    two packages sum the stack in different orders)."""
    if set(stored) != set(want):
        return False
    for key, value in want.items():
        if key == "data_fingerprint":
            if not fingerprints_match(stored[key], value, SUMMATION_RTOL):
                return False
        elif stored[key] != value:
            return False
    return True


class DeviceOptimizerCheckpointer:
    """Saves the device optimizer's full state between segments
    (``<directory>/<tag>_device_lbfgs.npz``, the JAX package's file),
    written atomically; a checkpoint of another configuration (meta or
    layout) is ignored with a warning rather than trusted, unless it is a
    stamped checkpoint of a multi-rank fit (:class:`ElasticResumeError`).
    ``elastic`` (``coord.elastic_meta``) is stamped into the meta and
    compared apart from the fit's identity."""

    def __init__(self, directory: str, tag: str = "gp",
                 elastic: Optional[dict] = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{tag}_device_lbfgs.npz")
        self.elastic = elastic

    def build_arrays(self, state, meta: dict) -> dict:
        """The payload: one lane's state (a device state dict or an
        ``_LbfgsState``) as ``leaf_i`` arrays, the meta (with the elastic
        stamp) and the checksum -- apart from the write, so the
        coordinated shell can check every rank's digest first."""
        from spark_gp_tpu_torch.optimize.lbfgs_device import host_state

        if self.elastic is not None and "elastic" not in meta:
            meta = {**meta, "elastic": self.elastic}
        host = host_state(state) if isinstance(state, dict) else state
        arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(host)}
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        arrays["checksum"] = np.frombuffer(_npz_digest(arrays).encode(), dtype=np.uint8)
        return arrays

    def write_arrays(self, arrays: dict) -> None:
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, **arrays)
        _fsync_replace(tmp, self.path)

    def save(self, state, meta: dict) -> None:
        self.write_arrays(self.build_arrays(state, meta))

    def load(self, template: dict, meta: dict):
        """The stored ``_LbfgsState``, or None when there is none or it was
        written for another configuration; ``template`` is
        ``lbfgs_device.state_template``'s ``{field: (shape, dtype)}``.
        Raises :class:`CheckpointCorruptError` on a checksum failure.

        The ``elastic`` stamp is compared apart from the fit's identity: an
        identity match under another process count is an elastic resume
        (loaded, counted as ``coord.elastic_resumes``); an identity
        mismatch on a payload stamped by more than one process raises
        :class:`ElasticResumeError`.  Stampless payloads keep the
        warn-and-ignore rule."""
        from spark_gp_tpu_torch.optimize.lbfgs_device import STATE_FIELDS, _LbfgsState

        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as npz:
            if "checksum" in npz.files:
                stored = bytes(npz["checksum"]).decode()
                if stored != _npz_digest({k: npz[k] for k in npz.files}):
                    raise CheckpointCorruptError(
                        f"device checkpoint {self.path} failed its content checksum; "
                        "delete it to restart the fit from scratch"
                    )
            stored_meta = json.loads(bytes(npz["meta_json"]))
            want_meta = dict(meta)
            stored_elastic = stored_meta.pop("elastic", None)
            want_elastic = want_meta.pop("elastic", self.elastic)
            if not _meta_matches(stored_meta, want_meta):
                stored_procs = (stored_elastic or {}).get("process_count") or 1
                if stored_procs > 1:
                    diff = sorted(k for k in set(stored_meta) | set(want_meta)
                                  if stored_meta.get(k) != want_meta.get(k))
                    raise ElasticResumeError(
                        f"device checkpoint {self.path} was written by a {stored_procs}-process "
                        f"coordinated fit but its identity differs from this fit (mismatched: "
                        f"{diff}); it cannot seed this configuration -- clear the directory or "
                        "fix the configuration to match the interrupted run")
                warnings.warn(
                    f"ignoring device checkpoint {self.path}: configuration changed "
                    f"({stored_meta} != {want_meta})",
                    stacklevel=2,
                )
                return None
            stored_procs = (stored_elastic or {}).get("process_count")
            want_procs = (want_elastic or {}).get("process_count")
            if stored_elastic is not None and stored_procs != want_procs:
                note_elastic_resume(stored_procs, want_procs)
            leaves = []
            for i, field in enumerate(STATE_FIELDS):
                key = f"leaf_{i}"
                shape, dtype = template[field]
                if key not in npz.files or npz[key].shape != tuple(shape) \
                        or npz[key].dtype != dtype:
                    warnings.warn(f"ignoring device checkpoint {self.path}: state layout changed",
                                  stacklevel=2)
                    return None
                leaves.append(np.array(npz[key]))
        return _LbfgsState(*leaves)


def run_segmented(vag, start, cfg, saver, meta: dict, max_iter: int, chunk: int,
                  loop_metrics: Optional[dict] = None, aux0=None):
    """The segmented device fit's loop: load the state ``saver`` holds for
    ``meta`` (a resume skips the initial evaluation) or start at ``start``
    ``[h]`` (a latent objective from the modes ``aux0``, ``[1, ...]``),
    advance it ``chunk`` iterations at a time on one
    ``lbfgs_device.DeviceLoop`` (one captured step on the card), and hand
    the state to ``saver.save`` after each segment.  Returns the final
    one-lane state dict; ``loop_metrics`` receives the loop's metrics and
    ``resumed_from_iteration``."""
    from spark_gp_tpu_torch.optimize.lbfgs_device import (
        DeviceLoop,
        device_state,
        lbfgs_init_state,
        state_template,
    )
    from spark_gp_tpu_torch.parallel import coord
    from spark_gp_tpu_torch.resilience import chaos
    from spark_gp_tpu_torch.resilience.chaos import SimulatedPreemption

    aux_shape = () if aux0 is None else tuple(aux0.shape[1:])
    host = saver.load(state_template(int(start.shape[0]), start.dtype, cfg.m_hist, aux_shape),
                      meta)
    from spark_gp_tpu_torch.obs.cost import ReplayMeter

    meter = ReplayMeter("fit.device")
    if host is None:
        with meter.initial():
            state, resumed = lbfgs_init_state(vag, start[None], cfg, aux0), 0
    else:
        state, resumed = device_state(host, cfg, start.device, vag), int(host.n_iter)
    loop = DeviceLoop(vag, state, cfg, meter=meter)
    try:
        # the SIGTERM watch spans the segment loop: the saves at its
        # boundaries act on the flag (nothing store-bound or signal-bound
        # enters the captured step)
        with coord.preemption_watch():
            while True:
                loop.counts["host_syncs"] += 1
                done, n_iter = _host_ints(loop.state["done"][0], loop.state["n_iter"][0])
                if done or n_iter >= max_iter:
                    break
                loop.advance(min(n_iter + int(chunk), int(max_iter)), warm=host is None)
                saver.save(loop.state, meta)
                chaos.tick_kill_counter()
                _raise_if_preempted()
    except SimulatedPreemption as exc:
        exc.nfev = int(loop.state["n_fev"][0])
        exc.loop_metrics = loop.counts
        raise
    finally:
        meter.finish()
        loop.release()
        if loop_metrics is not None:
            loop_metrics.update(loop.counts, resumed_from_iteration=resumed)
    return loop.state


def _host_ints(*scalars):
    """Device scalars read back in one transfer, as int64."""
    import torch

    return torch.stack([s.to(torch.int64) for s in scalars]).cpu().tolist()
