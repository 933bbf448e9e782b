"""Model files move between the JAX package and the port in both
directions (``utils/serialization.py``): a JAX-saved ``.npz`` loads in the
port and a port-saved one in the JAX package, and both predict the same
(float64, rel 1e-10), for every model ``kind`` and kernel family.  Damaged,
newer and foreign files are refused with the named errors."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import io
import json
import pickle

import numpy as np
import pytest

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models.gp_poisson import GaussianProcessPoissonModel as JPoisson
from spark_gp_tpu.models.gpc import GaussianProcessClassificationModel as JGpc
from spark_gp_tpu.models.gpc_ep import GaussianProcessEPClassificationModel as JEp
from spark_gp_tpu.models.gpc_mc import GaussianProcessMulticlassModel as JMc
from spark_gp_tpu.models.gpr import GaussianProcessRegressionModel as JGpr
from spark_gp_tpu.models.ppa import ProjectedProcessRawPredictor as JRaw
from spark_gp_tpu.utils.serialization import load_model as j_load
from spark_gp_tpu_torch.kernels.base import ThetaOverrideKernel as TOverride
from spark_gp_tpu_torch.models.gp_poisson import GaussianProcessPoissonModel as TPoisson
from spark_gp_tpu_torch.models.gpc import GaussianProcessClassificationModel as TGpc
from spark_gp_tpu_torch.models.gpc_ep import GaussianProcessEPClassificationModel as TEp
from spark_gp_tpu_torch.models.gpc_mc import GaussianProcessMulticlassModel as TMc
from spark_gp_tpu_torch.models.gpr import GaussianProcessRegressionModel as TGpr
from spark_gp_tpu_torch.utils.checkpoint import CheckpointCorruptError
from spark_gp_tpu_torch.utils.serialization import (
    FORMAT_VERSION,
    ModelFormatError,
    dump_kernel_pickle,
    load_kernel_pickle,
    load_model,
)
from spark_gp_tpu.kernels.base import ThetaOverrideKernel as JOverride

P, M = 3, 12


def _kernel(m, name):
    ard = np.array([0.5, 1.0, 2.0])
    return {
        "rbf": lambda: m.RBFKernel(0.5) + m.Const(1e-3) * m.EyeKernel(),
        "ard": lambda: 1.0 * m.ARDRBFKernel(ard) + m.Const(1e-3) * m.EyeKernel(),
        "matern": lambda: m.Matern32Kernel(0.7) + m.ARDMatern52Kernel(ard),
        "sum_product_scale_eye": lambda: 1.5 * m.RBFKernel(0.5) * m.PeriodicKernel()
        + m.Matern12Kernel(1.0) + m.Const(1e-3) * m.EyeKernel(),
        "rq_dot_poly": lambda: m.ARDRationalQuadraticKernel(ard) + m.DotProductKernel()
        + m.PolynomialKernel(2),
        "spectral_mixture": lambda: m.SpectralMixtureKernel(P, 2) + m.Const(1e-3) * m.EyeKernel(),
        "theta_override": lambda: (JOverride if m is jgp else TOverride)(
            m.RBFKernel(0.5) + m.Const(1e-3) * m.EyeKernel(), [0.8]),
    }[name]()


FAMILIES = ["rbf", "ard", "matern", "sum_product_scale_eye", "rq_dot_poly",
            "spectral_mixture", "theta_override"]
KINDS = {
    "regression": (JGpr, TGpr),
    "classification": (JGpc, TGpc),
    "ep_classification": (JEp, TEp),
    "multiclass": (JMc, TMc),
    "poisson": (JPoisson, TPoisson),
}


def _fields(kernel, kind="regression", seed=0, mean_only=False):
    rng = np.random.default_rng(seed)
    theta = kernel.init_theta() * rng.uniform(0.8, 1.2, size=kernel.n_hypers)
    a = rng.normal(size=(M, M)) * 0.1
    fields = {
        "theta": theta,
        "active": rng.normal(size=(M, P)),
        "magic_vector": rng.normal(size=(M, 3) if kind == "multiclass" else M),
        "magic_matrix": None if mean_only else -a @ a.T,
    }
    if kind == "regression":
        b = rng.normal(size=(M, M))
        fields.update(u1=b @ b.T, u2=rng.normal(size=M))
    return fields


def _jax_model(kind, kernel, fields):
    raw = JRaw(kernel=kernel, **fields)
    return KINDS[kind][0](raw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _jax_raw_out(raw, x):
    mean, var = raw(x)
    return np.asarray(mean), None if var is None else np.asarray(var)


def _port_raw_out(raw, x):
    mean, var = raw(x)
    return mean.numpy(), None if var is None else var.numpy()


def _x(seed=1, n=25):
    return np.random.default_rng(seed).normal(size=(n, P))


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_families_cross_both_ways(tmp_path, family):
    x = _x()
    jmodel = _jax_model("regression", _kernel(jgp, family), _fields(_kernel(jgp, family)))
    jmean, jvar = _jax_raw_out(jmodel.raw_predictor, x)
    jmodel.save(str(tmp_path / "jax.npz"))

    tmodel = load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert type(tmodel.raw_predictor.kernel).__module__.startswith("spark_gp_tpu_torch.")
    tmean, tvar = _port_raw_out(tmodel.raw_predictor, x)
    assert _rel(tmean, jmean) < 1e-10 and _rel(tvar, jvar) < 1e-10

    tmodel.save(str(tmp_path / "port.npz"))
    back = j_load(str(tmp_path / "port.npz"))
    assert type(back.raw_predictor.kernel).__module__.startswith("spark_gp_tpu.kernels")
    bmean, bvar = _jax_raw_out(back.raw_predictor, x)
    assert _rel(bmean, jmean) < 1e-10 and _rel(bvar, jvar) < 1e-10
    np.testing.assert_array_equal(back.raw_predictor.theta, jmodel.raw_predictor.theta)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_kind_crosses_both_ways(tmp_path, kind):
    x = _x(2)
    kernel = _kernel(jgp, "ard")
    fields = _fields(kernel, kind, seed=3)
    jmodel = _jax_model(kind, kernel, fields)
    jmodel.save(str(tmp_path / "jax.npz"))
    tmodel = KINDS[kind][1].load(str(tmp_path / "jax.npz"), device="cpu")
    assert type(tmodel) is KINDS[kind][1]
    jmean, jvar = _jax_raw_out(jmodel.raw_predictor, x)
    tmean, tvar = _port_raw_out(tmodel.raw_predictor, x)
    assert tmean.shape == jmean.shape
    assert _rel(tmean, jmean) < 1e-10 and _rel(tvar, jvar) < 1e-10
    if kind == "regression":
        np.testing.assert_array_equal(tmodel.raw_predictor.u1, fields["u1"])
    else:
        assert tmodel.raw_predictor.u1 is None

    tmodel.save(str(tmp_path / "port.npz"))
    back = j_load(str(tmp_path / "port.npz"))
    assert type(back) is KINDS[kind][0]
    bmean, bvar = _jax_raw_out(back.raw_predictor, x)
    assert _rel(bmean, jmean) < 1e-10 and _rel(bvar, jvar) < 1e-10


def test_fitted_port_model_round_trips_and_updates(tmp_path):
    """A fitted port model saves, reloads bit-equal in the port, loads in
    the JAX package, and keeps its statistics and provenance."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(160, P))
    y = np.sin(x.sum(1)) + 0.05 * rng.normal(size=160)
    model = tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0)) \
        .setDatasetSizeForExpert(40).setActiveSetSize(30).setMaxIter(5).fit(x, y)
    path = tmp_path / "fitted"          # ".npz" is appended, as np.savez does
    model.save(str(path))
    assert (tmp_path / "fitted.npz").exists() and (tmp_path / "fitted.npz.sha256").exists()
    again = TGpr.load(str(path), device="cpu")
    np.testing.assert_array_equal(again.predict_with_var(x[:9])[1], model.predict_with_var(x[:9])[1])
    assert again.provenance["process_count"] == 1
    assert again.provenance["degradations"] == []
    assert again.provenance["solver"]["solver_lane"] == "exact"
    # the fit-time covariate summary (the serve drift monitor's input) is
    # saved in the provenance and restored onto the loaded model
    assert again.provenance["covariate_summary"] == model.instr.covariate_summary
    assert again.covariate_summary == model.instr.covariate_summary
    assert again.covariate_summary["n"] == 160
    upd = again.update(x[:5], y[:5])
    ref = model.update(x[:5], y[:5])
    np.testing.assert_allclose(upd.predict(x[:7]), ref.predict(x[:7]), rtol=1e-12)
    jmodel = j_load(str(tmp_path / "fitted.npz"))
    assert _rel(np.asarray(jmodel.predict(x[:9])), model.predict(x[:9])) < 1e-10


def test_mean_only_model_round_trips(tmp_path):
    kernel = _kernel(jgp, "rbf")
    jmodel = _jax_model("regression", kernel, _fields(kernel, mean_only=True))
    jmodel.save(str(tmp_path / "m.npz"))
    tmodel = load_model(str(tmp_path / "m.npz"), device="cpu")
    assert tmodel.raw_predictor.magic_matrix is None
    assert _rel(tmodel.predict(_x()), np.asarray(jmodel.predict(_x()))) < 1e-10


def test_flipped_byte_is_refused(tmp_path):
    kernel = _kernel(jgp, "rbf")
    _jax_model("regression", kernel, _fields(kernel)).save(str(tmp_path / "m.npz"))
    path = tmp_path / "m.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x01
    path.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="content checksum") as info:
        load_model(str(path), device="cpu")
    assert info.value.code == "model_sidecar_digest_mismatch"


def test_newer_format_is_refused(tmp_path):
    path = tmp_path / "m.npz"
    with np.load(_saved(tmp_path, _kernel(jgp, "rbf"))) as data:
        arrays = dict(data)
    arrays["format_version"] = np.array(FORMAT_VERSION + 1)
    np.savez(path, **arrays)  # written without a sidecar
    with pytest.raises(ModelFormatError, match=f"v{FORMAT_VERSION + 1}"):
        load_model(str(path), device="cpu")


def _saved(tmp_path, kernel):
    path = str(tmp_path / "src.npz")
    _jax_model("regression", kernel, _fields(kernel)).save(path)
    return path


class _Evil:
    def __reduce__(self):
        return (print, ("side effect",))


def test_foreign_pickle_global_is_refused(tmp_path):
    with pytest.raises(ModelFormatError, match="builtins.print"):
        load_kernel_pickle(pickle.dumps(_Evil()))
    # a whole file carrying such a pickle is refused the same way
    path = tmp_path / "evil.npz"
    kernel = _kernel(jgp, "rbf")
    with np.load(_saved(tmp_path, kernel)) as data:
        arrays = dict(data)
    arrays["kernel_pickle"] = np.frombuffer(pickle.dumps(_Evil()), dtype=np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ModelFormatError, match="builtins.print"):
        load_model(str(path), device="cpu")
    # a jax array in the kernel state is refused by name
    with pytest.raises(ModelFormatError, match="jax array"):
        load_kernel_pickle(b"\x80\x03cjax._src.array\nArrayImpl\nq\x00.")


def test_port_pickle_names_only_the_reference_kernels():
    data = dump_kernel_pickle(_kernel(tgp, "rq_dot_poly"))
    names = {arg for op, arg, _ in __import__("pickletools").genops(data)
             if op.name == "GLOBAL"}
    assert all(not n.startswith("spark_gp_tpu_torch") for n in names)
    assert any(n.startswith("spark_gp_tpu.kernels.families") for n in names)
    # the JAX unpickler sees the reference's state names
    kernel = pickle.load(io.BytesIO(data))
    assert type(kernel).__module__ == "spark_gp_tpu.kernels.base"
    assert {"s0", "c0"} <= {k for child in (kernel.k1.k2, kernel.k2) for k in vars(child)}


def test_provenance_record_is_the_jax_one(tmp_path):
    model = load_model(_saved(tmp_path, _kernel(jgp, "rbf")), device="cpu")
    model.degradations = [{"failure_class": "oom", "to": "iterative"}]
    model.save(str(tmp_path / "p.npz"))
    with np.load(tmp_path / "p.npz") as data:
        prov = json.loads(bytes(data["provenance_json"]))
        assert str(data["kind"]) == "regression"
    assert prov == {"process_count": 1, "degradations": model.degradations}
    assert j_load(str(tmp_path / "p.npz")).degradations == model.degradations
