"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
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
