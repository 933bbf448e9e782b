"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_gp_tpu_torch as tgp
from spark_gp_tpu_torch.models import ppa
from spark_gp_tpu_torch.models.aggregation import redundancy_matrix
from spark_gp_tpu_torch.models.poe import make_poe_predictor
from spark_gp_tpu_torch.utils.device import resolve_device, working_dtype

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "spark_gp_tpu_torch"

FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    re.compile(r"^\s*(import|from)\s+spark_gp_tpu(\.|\s|$)", re.M),
    re.compile(r"\bspark_gp_tpu\.[a-z_]"),
    re.compile(r"import_module\(\s*['\"](jax|spark_gp_tpu)\b"),
]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, spark_gp_tpu_torch, spark_gp_tpu_torch.convert\n"
        "import spark_gp_tpu_torch.ops.cuda_lib, spark_gp_tpu_torch.data\n"
        "import spark_gp_tpu_torch.utils.validation, spark_gp_tpu_torch.ops.scaling\n"
        "import spark_gp_tpu_torch.models.laplace, spark_gp_tpu_torch.models.gpc\n"
        "import spark_gp_tpu_torch.ops.integrator\n"
        "import spark_gp_tpu_torch.models.laplace_mc, spark_gp_tpu_torch.models.gpc_mc\n"
        "import spark_gp_tpu_torch.models.loo, spark_gp_tpu_torch.models.sgpr\n"
        "import spark_gp_tpu_torch.models.active_set, spark_gp_tpu_torch.models.greedy\n"
        "import spark_gp_tpu_torch.models.ep, spark_gp_tpu_torch.models.gpc_ep\n"
        "import spark_gp_tpu_torch.models.laplace_generic\n"
        "import spark_gp_tpu_torch.models.gp_poisson\n"
        "import spark_gp_tpu_torch.models.poe, spark_gp_tpu_torch.models.aggregation\n"
        "import spark_gp_tpu_torch.resilience, spark_gp_tpu_torch.resilience.quarantine\n"
        "import spark_gp_tpu_torch.resilience.retry\n"
        "import spark_gp_tpu_torch.obs, spark_gp_tpu_torch.obs.names\n"
        "import spark_gp_tpu_torch.obs.trace, spark_gp_tpu_torch.obs.runtime\n"
        "import spark_gp_tpu_torch.obs.recorder, spark_gp_tpu_torch.obs.expo\n"
        "import spark_gp_tpu_torch.utils.instrumentation\n"
        "import spark_gp_tpu_torch.resilience.chaos, spark_gp_tpu_torch.resilience.memplan\n"
        "import spark_gp_tpu_torch.resilience.fallback\n"
        "import spark_gp_tpu_torch.resilience.breaker, spark_gp_tpu_torch.resilience.integrity\n"
        "import spark_gp_tpu_torch.utils.serialization, spark_gp_tpu_torch.utils.checkpoint\n"
        "import spark_gp_tpu_torch.serve, spark_gp_tpu_torch.serve.__main__\n"
        "import spark_gp_tpu_torch.serve.codes, spark_gp_tpu_torch.serve.queue\n"
        "import spark_gp_tpu_torch.serve.batcher, spark_gp_tpu_torch.serve.registry\n"
        "import spark_gp_tpu_torch.serve.lifecycle, spark_gp_tpu_torch.serve.server\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'spark_gp_tpu' or m.startswith('spark_gp_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_names_no_jax(path):
    text = (REPO / path).read_text()
    for pattern in FORBIDDEN:
        assert not pattern.search(text), f"{path} matches {pattern.pattern}"


def test_cuda_is_the_default_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(30, 2))
    y = x.sum(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.GaussianProcessRegression().setDatasetSizeForExpert(10).fit(x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    pred = ppa.ProjectedProcessRawPredictor(
        kernel=tgp.RBFKernel(), theta=np.ones(1), active=x[:4],
        magic_vector=np.ones(4), magic_matrix=None,
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pred.predict_mean(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_poe_predictor(tgp.RBFKernel(), np.ones(1), x, y, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        redundancy_matrix(np.ones((3, 4)))
    assert make_poe_predictor(tgp.RBFKernel(), np.ones(1), x, y, 10,
                              device="cpu").data.x.dtype == torch.float64
    # the shell's defaults stay on the card's side: no CUDA context, no
    # budget, no CUDA memory gauges
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.resilience import memplan

    assert memplan.memory_budget_bytes() is None
    assert set(telemetry.sample_memory()) == {"memory.host_peak_rss_bytes"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.GaussianProcessClassifier().setDatasetSizeForExpert(10).fit(x, (y > 0) * 1.0)
    assert resolve_device("cpu").type == "cpu"
    assert working_dtype(resolve_device("cpu")) == torch.float64
    model = tgp.GaussianProcessRegression(device="cpu").setDatasetSizeForExpert(10) \
        .setActiveSetSize(5).setMaxIter(2).fit(x, y)
    assert model.predict(x[:2]).dtype == np.float64


def _run_smoke(cwd, env=None):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_loading_a_jax_file_imports_no_jax(tmp_path):
    """A model the JAX package saved loads through the port in a process
    that never imports JAX or the JAX package (the restricted unpickler
    maps the reference's kernel classes onto the port's)."""
    import spark_gp_tpu as jgp
    from spark_gp_tpu.models.gpr import GaussianProcessRegressionModel
    from spark_gp_tpu.models.ppa import ProjectedProcessRawPredictor

    rng = np.random.default_rng(0)
    kernel = 1.0 * jgp.ARDRBFKernel(2, 0.7) + jgp.Const(1e-3) * jgp.EyeKernel()
    raw = ProjectedProcessRawPredictor(
        kernel=kernel, theta=kernel.init_theta(), active=rng.normal(size=(6, 2)),
        magic_vector=rng.normal(size=6), magic_matrix=-np.eye(6) * 0.1)
    GaussianProcessRegressionModel(raw).save(str(tmp_path / "jax.npz"))
    expected = np.asarray(raw.predict_mean(np.ones((1, 2))))[0]
    code = (
        "import sys, numpy as np\n"
        "from spark_gp_tpu_torch.models.gpr import GaussianProcessRegressionModel as M\n"
        f"m = M.load({str(tmp_path / 'jax.npz')!r}, device='cpu')\n"
        "print(repr(float(m.predict(np.ones((1, 2)))[0])))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'spark_gp_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert abs(float(proc.stdout.splitlines()[0]) - expected) <= 1e-12 * abs(expected)


def test_model_load_server_and_cli_default_to_cuda(tmp_path, monkeypatch, capsys):
    from spark_gp_tpu_torch.serve import GPServeServer
    from spark_gp_tpu_torch.serve import __main__ as cli

    x = np.random.default_rng(1).normal(size=(40, 2))
    tgp.GaussianProcessRegression(device="cpu").setDatasetSizeForExpert(10) \
        .setActiveSetSize(5).setMaxIter(2).fit(x, x.sum(1)).save(str(tmp_path / "m.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.GaussianProcessRegressionModel.load(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPServeServer()
    assert GPServeServer(device="cpu").device.type == "cpu"
    assert cli.main(["--model", f"m={tmp_path / 'm.npz'}"]) == 1
    event = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert event["event"] == "error" and "device='cpu'" in event["error"]
    # --preflight probes the card and never falls back to the CPU
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert cli.main(["--preflight", "--model", f"m={tmp_path / 'm.npz'}"]) == 1
    event = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert event == {"event": "error", "stage": "preflight", "error": event["error"]}
