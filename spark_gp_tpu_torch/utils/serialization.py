"""Model persistence in the JAX package's ``.npz`` format.

A fitted PPA model is small and self-contained: ``theta [h]``,
``active [m, p]``, ``magic_vector [m]`` (``[m, C]`` for the multiclass
model), ``magic_matrix [m, m]``, the regression statistics ``u1`` /
``u2``, a provenance record and the pickled kernel spec, saved as one
``.npz`` beside a sha256 sidecar (``resilience/integrity.py``).  The
layout is the JAX package's (``FORMAT_VERSION`` 2), in both directions: a
file either package saved loads in the other and predicts the same.

The kernel pickle is the one place where the packages differ.  The JAX
format pickles the kernel object under the reference package's module
paths (``<reference>.kernels.<module>.<Class>``); the port's kernels
carry the same class names and state, so

* :func:`load_model` unpickles with a restricted unpickler that maps
  those paths onto the port's ``kernels`` modules, admits numpy's array
  reconstructors and refuses every other global with
  :class:`ModelFormatError` naming it -- it never imports the reference
  package;
* :func:`save_model` pickles the port's kernels with the reference's
  class paths and state names, so the JAX loader builds its own kernels.

The reference package's name is the port's less its ``_torch`` suffix.
"""

from __future__ import annotations

import copyreg
import io
import json
import pickle
import pickletools

import numpy as np

from spark_gp_tpu_torch.kernels.base import Kernel
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor

# On-disk contract version (the JAX package's).  History:
#   (absent)  -- pre-versioning files: the same arrays, no marker.
#   2         -- the same layout with an explicit version marker.
# Readers accept every version <= FORMAT_VERSION and refuse newer files.
FORMAT_VERSION = 2

_PORT_PACKAGE = __name__.split(".")[0]
_REFERENCE_PACKAGE = _PORT_PACKAGE[: -len("_torch")]
#: the kernel modules whose classes a model file may name
_KERNEL_MODULES = ("base", "rbf", "matern", "families")

#: numpy globals a pickled kernel may hold (its ``beta0``, bounds and
#: spectral-mixture arrays), under numpy 1 and numpy 2 module names
_NUMPY_GLOBALS = frozenset(
    (module, name)
    for prefix in ("numpy.core", "numpy._core")
    for module, name in (
        (f"{prefix}.multiarray", "_reconstruct"),
        (f"{prefix}.multiarray", "scalar"),
        (f"{prefix}.numeric", "_frombuffer"),
    )
) | {("numpy", "ndarray"), ("numpy", "dtype")}

#: instance-state names that differ between the two packages' kernels:
#: class name -> {reference name: port name}
_STATE_RENAMES = {
    "DotProductKernel": {"s0": "h0"},
    "PolynomialKernel": {"c0": "h0"},
}
#: instance state the port keeps and the reference computes: class name ->
#: keys to drop on save and rebuild on load
_PORT_ONLY_STATE = {"SpectralMixtureKernel": ("n_hypers",)}


class ModelFormatError(ValueError):
    """A saved model cannot be read by this build: a newer
    ``format_version``, or a kernel pickle that names a global outside the
    kernel classes and numpy's array reconstructors."""


def _normalize(path: str) -> str:
    """``np.savez`` appends ``.npz`` to bare paths; keep save/load symmetric."""
    return path if path.endswith(".npz") else path + ".npz"


# --- the kernel pickle --------------------------------------------------


class _KernelUnpickler(pickle.Unpickler):
    """Resolves the reference's kernel classes to the port's, numpy's
    array reconstructors to numpy, and refuses everything else."""

    def find_class(self, module: str, name: str):
        pkg, _, rest = module.partition(".")
        sub = rest.split(".")
        if (pkg in (_REFERENCE_PACKAGE, _PORT_PACKAGE) and len(sub) == 2
                and sub[0] == "kernels" and sub[1] in _KERNEL_MODULES):
            import importlib

            target = importlib.import_module(f"{_PORT_PACKAGE}.kernels.{sub[1]}")
            cls = getattr(target, name, None)
            if isinstance(cls, type) and issubclass(cls, Kernel):
                return cls
        elif (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        hint = (" (a jax array in the kernel's state: re-save the model with "
                "numpy-valued kernel state)" if pkg in ("jax", "jaxlib") else "")
        raise ModelFormatError(
            f"the model's kernel pickle names the global {module}.{name}, which "
            f"is not a kernel class of {_REFERENCE_PACKAGE} or {_PORT_PACKAGE} "
            f"nor a numpy array reconstructor; refusing to load it{hint}"
        )


def _walk_kernels(kernel):
    """Every kernel object in a kernel tree (the pair, scale and override
    kernels hold their children in ``k1`` / ``k2``, ``kernel``, ``inner``)."""
    stack, seen = [kernel], set()
    while stack:
        k = stack.pop()
        if not isinstance(k, Kernel) or id(k) in seen:
            continue
        seen.add(id(k))
        yield k
        stack.extend(getattr(k, attr, None) for attr in ("k1", "k2", "kernel", "inner"))


def _to_port_state(kernel: Kernel) -> Kernel:
    """Rename and rebuild the state of kernels unpickled from a reference
    file (a no-op on the port's own files)."""
    for k in _walk_kernels(kernel):
        state = vars(k)
        for ref_name, port_name in _STATE_RENAMES.get(type(k).__name__, {}).items():
            if ref_name in state:
                state[port_name] = state.pop(ref_name)
        if type(k).__name__ == "SpectralMixtureKernel" and "n_hypers" not in state:
            state["n_hypers"] = k.q + 2 * k.q * k.p
    return kernel


def load_kernel_pickle(data: bytes) -> Kernel:
    """The port kernel a model file's ``kernel_pickle`` holds; raises
    :class:`ModelFormatError` for a pickle naming any other global."""
    kernel = _KernelUnpickler(io.BytesIO(data)).load()
    if not isinstance(kernel, Kernel):
        raise ModelFormatError(
            f"the model's kernel pickle holds a {type(kernel).__name__}, not a kernel"
        )
    return _to_port_state(kernel)


class _ReferencePickler(pickle.Pickler):
    """Pickles port kernels with the reference's state names; the class
    paths are rewritten by :func:`dump_kernel_pickle`."""

    def reducer_override(self, obj):
        if not isinstance(obj, Kernel):
            return NotImplemented
        cls = type(obj)
        state = dict(vars(obj))
        for key in _PORT_ONLY_STATE.get(cls.__name__, ()):
            state.pop(key, None)
        for ref_name, port_name in _STATE_RENAMES.get(cls.__name__, {}).items():
            if port_name in state:
                state[ref_name] = state.pop(port_name)
        return copyreg.__newobj__, (cls,), state


def dump_kernel_pickle(kernel: Kernel) -> bytes:
    """``kernel`` pickled as the reference package would pickle its own
    kernel of the same expression: protocol 3, whose class references are
    text ``GLOBAL`` opcodes, each port kernel path rewritten to the
    reference's.  Nothing of the reference package is imported."""
    buf = io.BytesIO()
    _ReferencePickler(buf, protocol=3).dump(kernel)
    data = buf.getvalue()
    port_prefix = f"{_PORT_PACKAGE}.kernels."
    out, last = [], 0
    ops = list(pickletools.genops(data))
    for i, (opcode, arg, pos) in enumerate(ops):
        if opcode.name != "GLOBAL" or not arg.startswith(port_prefix):
            continue
        module, name = arg.split(" ", 1)
        end = ops[i + 1][2]
        out.append(data[last:pos])
        ref_module = _REFERENCE_PACKAGE + module[len(_PORT_PACKAGE):]
        out.append(b"c" + ref_module.encode() + b"\n" + name.encode() + b"\n")
        last = end
    out.append(data[last:])
    return b"".join(out)


# --- save / load ----------------------------------------------------------


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _provenance(model) -> dict:
    """The JAX package's provenance record: ``process_count``, the ladder's
    ``degradations``, the ``solver`` / ``aggregation`` keys of the fit's
    metrics, and the fit-time ``covariate_summary``
    (``obs/quality.summarize_covariates``), which the serve drift monitor
    scores incoming rows against: carried on the model (a load -> save
    round trip) or on its fit's instrumentation (a fresh fit)."""
    instr = getattr(model, "instr", None)
    covariate_summary = (getattr(model, "covariate_summary", None)
                         or (getattr(instr, "covariate_summary", None) if instr else None))
    fit_metrics = dict(getattr(instr, "metrics", {}) or {}) if instr is not None else {}
    if not fit_metrics:
        fit_metrics = dict(getattr(model, "metrics", None) or {})
    solver = {k: fit_metrics[k] for k in (
        "solver_lane", "solver.cg_iters", "solver.precond_rank", "solver.probes",
        "solver.residual") if k in fit_metrics}
    aggregation = {k: fit_metrics[k] for k in (
        "agg.policy", "agg.effective_experts", "agg.selection_dropped",
        "agg.renorm") if k in fit_metrics}
    return {
        "process_count": _process_count(),
        "degradations": list(getattr(model, "degradations", None) or ()),
        **({"solver": solver} if solver else {}),
        **({"aggregation": aggregation} if aggregation else {}),
        **({"covariate_summary": covariate_summary} if covariate_summary else {}),
    }


def save_model(path: str, model, kind: str) -> None:
    """Write ``model`` (any of the port's fitted models) to ``path``
    (``.npz`` appended when missing) with its sha256 sidecar."""
    from spark_gp_tpu_torch.resilience import integrity

    raw = model.raw_predictor
    extras = {}
    if raw.u1 is not None:
        extras["u1"] = np.asarray(raw.u1, dtype=np.float64)
        extras["u2"] = np.asarray(raw.u2, dtype=np.float64)
    extras["provenance_json"] = np.frombuffer(
        json.dumps(_provenance(model)).encode(), dtype=np.uint8
    )
    np.savez(
        _normalize(path),
        format_version=np.array(FORMAT_VERSION),
        kind=np.array(kind),
        theta=np.asarray(raw.theta, dtype=np.float64),
        active=np.asarray(raw.active, dtype=np.float64),
        magic_vector=np.asarray(raw.magic_vector, dtype=np.float64),
        # a mean-only model has no [m, m] operator: the empty sentinel
        magic_matrix=(np.zeros((0, 0)) if raw.magic_matrix is None
                      else np.asarray(raw.magic_matrix, dtype=np.float64)),
        kernel_pickle=np.frombuffer(dump_kernel_pickle(raw.kernel), dtype=np.uint8),
        **extras,
    )
    integrity.write_sidecar(_normalize(path))


def _model_class(kind: str):
    if kind == "classification":
        from spark_gp_tpu_torch.models.gpc import GaussianProcessClassificationModel as cls
    elif kind == "ep_classification":
        from spark_gp_tpu_torch.models.gpc_ep import GaussianProcessEPClassificationModel as cls
    elif kind == "multiclass":
        from spark_gp_tpu_torch.models.gpc_mc import GaussianProcessMulticlassModel as cls
    elif kind == "poisson":
        from spark_gp_tpu_torch.models.gp_poisson import GaussianProcessPoissonModel as cls
    else:
        from spark_gp_tpu_torch.models.gpr import GaussianProcessRegressionModel as cls
    return cls


def load_model(path: str, device=None):
    """The model saved at ``path`` by either package, predicting on
    ``device`` (``None`` means ``cuda``; raises without a GPU unless
    ``"cpu"`` is asked for).  The sidecar is verified first
    (``CheckpointCorruptError``), then the format version
    (:class:`ModelFormatError`)."""
    from spark_gp_tpu_torch.resilience import integrity
    from spark_gp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    path = _normalize(path)
    integrity.verify_sidecar(path)
    with np.load(path, allow_pickle=False) as data:
        version = int(data["format_version"]) if "format_version" in data else 1
        if version > FORMAT_VERSION:
            raise ModelFormatError(
                f"{path} was saved with model format v{version}, but this build "
                f"reads up to v{FORMAT_VERSION}. Load it with the version that "
                "wrote it, or re-save it there with an older format."
            )
        kind = str(data["kind"])
        kernel = load_kernel_pickle(data["kernel_pickle"].tobytes())
        provenance = (json.loads(bytes(data["provenance_json"]))
                      if "provenance_json" in data else None)
        magic_matrix = data["magic_matrix"]
        raw = ProjectedProcessRawPredictor(
            kernel=kernel,
            theta=np.asarray(data["theta"], dtype=np.float64),
            active=np.asarray(data["active"], dtype=np.float64),
            magic_vector=np.asarray(data["magic_vector"], dtype=np.float64),
            magic_matrix=None if magic_matrix.size == 0 else np.asarray(magic_matrix),
            u1=data["u1"] if "u1" in data else None,
            u2=data["u2"] if "u2" in data else None,
            device=str(dev),
        )
    model = _model_class(kind)(raw)
    model.provenance = provenance
    # the drift monitor's input (obs/quality.py): the serve registry binds
    # a DriftMonitor from the model without re-reading provenance
    model.covariate_summary = provenance.get("covariate_summary") if provenance else None
    if provenance and provenance.get("degradations"):
        # a save -> load -> save round trip keeps the ladder's history
        model.degradations = provenance["degradations"]
    return model


def load_as(path: str, cls, device=None):
    """:func:`load_model`, refusing a file of another model class
    (``TypeError``): the models' ``load`` static methods."""
    model = load_model(path, device)
    if not isinstance(model, cls):
        raise TypeError(f"{_normalize(path)} holds a {type(model).__name__}, not a {cls.__name__}")
    return model
