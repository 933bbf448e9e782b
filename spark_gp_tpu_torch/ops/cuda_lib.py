"""Build and load the port's hand-written CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exposes plain C functions.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library at
first use and loaded with :mod:`ctypes` -- no PyTorch headers, so a build
takes seconds.  Libraries are keyed by a digest of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
The build directory ``csrc/build/`` is listed in ``.gitignore``.  Each
build compiles into a temporary file there and renames it into place
(``os.replace``, atomic), so processes that build the same source at once
-- the ranks of a process group at their first launch -- each load a
whole library, and the last rename leaves the same bytes.

A failed build raises :class:`KernelBuildError`, a failed launch
:class:`KernelLaunchError` and a CUDA graph that could not be captured
:class:`GraphCaptureError` (all ``RuntimeError``s): the degradation
ladder classifies them by type as ``unknown`` and never degrades them
(``resilience/fallback.py``).  Every build counts
``kernel.builds.<name>`` and every launch ``kernel.launches.<name>`` in
the runtime telemetry (``obs/runtime.py``).  A wrapper called while a
CUDA graph is being captured under :func:`capture_tally` launches
nothing yet: it tallies the launch into the graph's record, and each
replay of the graph counts the tallied launches (:func:`count_replays`).

Nothing here runs at import: the CPU test harness has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from spark_gp_tpu_torch.obs import cost as obs_cost
from spark_gp_tpu_torch.obs import trace as obs_trace
from spark_gp_tpu_torch.obs.runtime import telemetry

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: dict = {}


class KernelBuildError(RuntimeError):
    """A hand-written kernel could not be built or loaded (no ``nvcc``, a
    compiler error, a library that disagrees with its wrapper)."""


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch returned a CUDA error."""


class GraphCaptureError(RuntimeError):
    """Work that must run from a captured CUDA graph could not be
    captured (an operation that reads the device from the host, or one
    the capture refuses)."""


def count_launch(name: str, n: float = 1.0) -> None:
    """``n`` launches of kernel ``name`` in the runtime telemetry,
    attributed to the active trace root: a host dict update, no device
    work."""
    telemetry.inc(f"kernel.launches.{name}", n=n)


_CAPTURE = threading.local()


@contextlib.contextmanager
def capture_tally():
    """Around a CUDA graph capture: the wrappers called inside, while the
    stream captures, tally their launches into the yielded dict (kernel
    name -> ``[wrapper, launches, flops, bytes]`` per replay) instead of
    counting them."""
    prev = getattr(_CAPTURE, "tally", None)
    tally: dict = {}
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = prev


@contextlib.contextmanager
def collector_held():
    """Around a CUDA graph capture: hold Python's cyclic garbage collector
    off until the capture ends, so no finalizer of a dead reference cycle
    runs on the capturing thread mid-capture (a dead CUDA graph's
    ``reset`` there is an API call the capture forbids, and it invalidates
    the capture); the cycle is collected after."""
    import gc

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def record_launch(wrapper, name: str, work=None) -> None:
    """The wrappers' one launch counter: ``wrapper.launches`` and the
    telemetry count one launch, or, while a graph captures under
    :func:`capture_tally`, the capture's tally does.  ``work`` is the
    launch's ``(flops, bytes)`` from its kernel's work model, which goes
    to the cost meter (``obs/cost.py``) with the launch, or with each
    replay of the graph that tallied it."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            row = tally.setdefault(name, [wrapper, 0, 0.0, 0.0])
            row[1] += 1
            if work is not None:
                row[2] += float(work[0])
                row[3] += float(work[1])
            return
    wrapper.launches += 1
    count_launch(name)
    obs_cost.note_kernel(name, work)


def record_plain(name: str, work) -> None:
    """A wrapper's plain branch did its kernel's work (on the CPU): the
    cost meter counts the kernel's work model, as for a launch; no launch
    is counted."""
    obs_cost.note_kernel(name, work)


def count_replays(tally: dict, replays: int) -> None:
    """Count the launches of ``replays`` replays of a graph whose capture
    tallied ``tally``: each replay launches every tallied kernel again,
    and does its work again (``obs/cost.py``)."""
    for name, (wrapper, per_replay, flops, nbytes) in tally.items():
        n = int(per_replay) * int(replays)
        if n:
            wrapper.launches += n
            count_launch(name, n)
            obs_cost.note_kernel(name, (flops * replays, nbytes * replays), n)


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, the ``PATH``, or the
    toolkit's default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise KernelBuildError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit to build the "
        "port's kernels"
    )


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``; ``name`` may name a subdirectory
    (``dev/<file>``)."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(name).name}-{digest}.so"


def build_all(names, force: bool = False) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built
    already (all of them with ``force``), one ``nvcc`` per source, all
    started together.  Returns ``{name: (seconds, log)}`` for the compiles
    made now (``log`` is nvcc's ``-Xptxas -v`` report); raises
    :class:`KernelBuildError` with the compiler's output when a build
    fails."""
    todo = [n for n in names if force or not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    start = time.perf_counter()
    jobs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[name] = (proc, tmp)
    done, failed = {}, []
    for name, (proc, tmp) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, library_path(name))
        done[name] = (time.perf_counter() - start, log)
        telemetry.inc(f"kernel.builds.{Path(name).name}")
        obs_trace.add_event("kernel.build", kernel=name, seconds=done[name][0])
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
