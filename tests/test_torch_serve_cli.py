"""The port's serve CLI (``python -m spark_gp_tpu_torch.serve``) in a
subprocess on the CPU (``--device cpu``): the ready contract, the JSON
lines protocol (predict, errors, health, metrics, observe), TCP mode,
and SIGTERM draining to ``{"event": "shutdown", "drained": true}`` with
exit 0.  Every subprocess is fenced by a 60 s kill of its process
group."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import json
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import spark_gp_tpu_torch as tgp

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(120, 3))
    y = np.sin(x.sum(axis=1))
    model = (tgp.GaussianProcessRegression(device="cpu").setKernel(lambda: tgp.RBFKernel(1.0))
             .setDatasetSizeForExpert(30).setActiveSetSize(30).setSigma2(1e-3).setMaxIter(5)
             .setSeed(1).fit(x, y))
    path = str(tmp_path_factory.mktemp("cli") / "tiny.npz")
    model.save(path)
    return path, model, x


def _start(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_gp_tpu_torch.serve", "--device", "cpu", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO, start_new_session=True,
    )
    fence = threading.Timer(TIMEOUT_S, lambda: os.killpg(proc.pid, signal.SIGKILL))
    fence.start()
    return proc, fence


def _finish(proc, fence):
    try:
        rest, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        fence.cancel()
    return proc.returncode, rest, err


def _send(proc, *messages):
    for msg in messages:
        proc.stdin.write((msg if isinstance(msg, str) else json.dumps(msg)) + "\n")
    proc.stdin.flush()


def _read_until(proc, done):
    events = []
    while True:
        line = proc.stdout.readline()
        assert line, "the server closed its output early"
        events.append(json.loads(line))
        if done(events[-1]):
            return events


def test_cli_boot_score_and_sigterm_drain(tiny_model):
    path, model, x = tiny_model
    proc, fence = _start(["--model", f"tiny={path}", "--max-batch", "16", "--min-bucket", "4",
                          "--replica-id", "cli-r0", "--preflight"])
    ready = _read_until(proc, lambda e: True)[0]
    assert ready["event"] == "ready" and ready["platform"] == "cpu"
    [desc] = ready["models"]
    assert desc["name"] == "tiny" and desc["version"] == 1
    assert {int(b): c for b, c in desc["compiles"].items()} == {4: 1, 8: 1, 16: 1}
    assert ready["buckets_warmed"] == 3

    _send(proc,
          {"id": 1, "model": "tiny", "x": x[:3].tolist(), "request_id": "r-1"},
          "this is not json",
          {"id": 7, "model": "ghost", "x": x[:2].tolist()},
          {"id": 8, "model": "tiny", "x": x[3:25].tolist()},
          {"cmd": "health"},
          {"cmd": "observe", "model": "tiny", "request_id": "r-1", "y": [0.0, 0.0, 0.0]},
          {"cmd": "metrics", "format": "openmetrics"},
          {"cmd": "metrics"})
    events = _read_until(proc, lambda e: e.get("event") == "metrics" and "counters" in e)
    by_id = {e["id"]: e for e in events if "id" in e}
    # float64 on the CPU: the model's own answers
    np.testing.assert_allclose(by_id[1]["mean"], model.predict(x[:3]), rtol=1e-12)
    assert by_id[1]["request_id"] == "r-1" and len(by_id[1]["var"]) == 3
    np.testing.assert_allclose(by_id[8]["mean"], model.predict(x[3:25]), rtol=1e-12)
    assert "KeyError" in by_id[7]["error"]
    assert any("bad request line" in e.get("error", "") for e in events)
    health = next(e for e in events if e.get("event") == "health")
    assert health["status"] == "ok" and health["replica"]["replica_id"] == "cli-r0"
    # the observe verb joins request r-1's three labels (quality on by default)
    observed = next(e for e in events if e.get("event") == "observed")
    assert "error" not in observed, observed
    assert observed["joined"] == 3 and observed["duplicate"] is False
    page = next(e for e in events if e.get("format") == "openmetrics")["body"]
    assert "gp_requests_total" in page and page.endswith("# EOF\n")
    assert events[-1]["counters"]["requests"] == 2
    assert "request_latency_s" in events[-1]["histograms"]

    proc.send_signal(signal.SIGTERM)
    rc, rest, err = _finish(proc, fence)
    assert rc == 0, err[-500:]
    last = json.loads(rest.strip().splitlines()[-1])
    assert last["event"] == "shutdown" and last["drained"] is True and last["requests"] == 2


def test_cli_tcp_mode_serves_and_shuts_down(tiny_model):
    path, model, x = tiny_model
    proc, fence = _start(["--model", f"tiny={path}", "--max-batch", "8", "--port", "0"])
    events = _read_until(proc, lambda e: e.get("event") == "listening")
    assert events[0]["event"] == "ready"
    port = events[-1]["port"]
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S) as conn, \
            conn.makefile("r") as rf:
        conn.sendall((json.dumps({"id": 3, "model": "tiny", "x": x[:5].tolist()}) + "\n"
                      + json.dumps({"cmd": "health"}) + "\n").encode())
        replies = [json.loads(rf.readline()) for _ in range(2)]
        conn.sendall((json.dumps({"cmd": "shutdown"}) + "\n").encode())
        shutdown = json.loads(rf.readline())
    answer = next(r for r in replies if r.get("id") == 3)
    np.testing.assert_allclose(answer["mean"], model.predict(x[:5]), rtol=1e-12)
    assert next(r for r in replies if r.get("event") == "health")["status"] == "ok"
    assert shutdown["event"] == "shutdown" and shutdown["requests"] == 1
    rc, _, err = _finish(proc, fence)
    assert rc == 0, err[-500:]


def test_cli_requires_a_model(capsys):
    from spark_gp_tpu_torch.serve.__main__ import main

    assert main(["--device", "cpu"]) == 2
    assert "--model" in capsys.readouterr().err
