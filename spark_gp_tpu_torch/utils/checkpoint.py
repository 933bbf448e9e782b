"""Preemption-safe checkpoints of the host L-BFGS-B optimizer (the host
half of the JAX package's ``utils/checkpoint.py``).

:class:`LbfgsCheckpointer` is the optimizer's per-iteration callback: it
saves theta, the iteration count and the estimator seed as one JSON
payload (the JAX package's keys), plus the log of every objective
evaluation so far (``evaluations``: theta, value, gradient) and the
kernel and data fingerprints that tie the log to its fit.
``setCheckpointDir`` installs it, and a refit of the same kernel on the
same data resumes
(``models/common.GaussianProcessCommons._optimize_hypers_body``): SciPy's
L-BFGS-B keeps its curvature pairs to itself, so the port restarts it
from the initial theta and answers its evaluations from the log, which
rebuilds the optimizer's state exactly at no objective cost; from the
preempted iteration on the fit runs live and retraces the uninterrupted
one.  A payload without the log resumes as the JAX package's does, from
the saved theta with the remaining iteration budget.  The device
optimizer's segment checkpointer comes with that optimizer (ROADMAP.md
queue 1, item 4).

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


def _children(kernel):
    return [c for c in (getattr(kernel, a, None) for a in ("k1", "k2", "kernel", "inner"))
            if c is not None and hasattr(c, "n_hypers")]


def kernel_signature(kernel, theta_dim: int) -> str:
    """Structural identity of a kernel configuration: the class tree with
    each node's hyperparameter count (no values), so that a checkpoint is
    not resumed under another kernel that happens to share ``theta_dim``."""

    def render(k) -> str:
        inner = ",".join(render(c) for c in _children(k))
        return f"{type(k).__name__}[{int(k.n_hypers)}]({inner})"

    return f"{render(kernel)}/{int(theta_dim)}"


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


class LbfgsCheckpointer:
    """Host L-BFGS-B callback that saves the optimizer's state each
    iteration.

    ``tag`` (the estimator's class name, plus the objective) keys the file,
    so fits of different families or objectives sharing a directory do
    not meet.  The payload: theta, the iteration count (the resume budget),
    the seed, the evaluation log, and what ties the log to its fit: the
    kernel's :func:`kernel_fingerprint` and ``data``, the
    :func:`data_fingerprint` of the fitted stack."""

    def __init__(self, directory: str, kernel, tag: str = "gp",
                 seed: Optional[int] = None, data: Optional[list] = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"lbfgs_state_{tag}.json")
        self.kernel = kernel
        self.seed = seed
        self.data = data
        self.iteration = 0
        #: every objective evaluation so far: [theta, value, gradient]
        self.evaluations: list = []

    def record(self, theta, value, grad) -> None:
        """Log one objective evaluation (the optimizer calls this for each,
        replayed or live)."""
        self.evaluations.append([np.asarray(theta, dtype=np.float64).tolist(), float(value),
                                 np.asarray(grad, dtype=np.float64).tolist()])

    def build_payload(self, theta) -> dict:
        """Advance the iteration state and render the payload."""
        theta = np.asarray(theta, dtype=np.float64)
        self.iteration += 1
        payload = {
            "format_version": 2,
            "iteration": self.iteration,
            "theta": theta.tolist(),
            "seed": self.seed,
            "kernel": kernel_fingerprint(self.kernel),
            "kernel_sig": kernel_signature(self.kernel, theta.shape[0]),
            "data_fingerprint": self.data,
            "evaluations": list(self.evaluations),
        }
        payload["checksum"] = _payload_checksum(payload)
        return payload

    def write_payload(self, payload: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
            fh.flush()
        _fsync_replace(tmp, self.path)

    def __call__(self, theta) -> None:
        self.write_payload(self.build_payload(theta))


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
