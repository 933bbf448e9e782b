"""The port's fault injectors (``resilience/chaos.py``) against the JAX
package's, on the CPU.  Held exactly: ``poison_expert``'s rows, bit for
bit, for every kind and two seeds.  The injectors' counters, their op and
size filters and their ``GP_CHAOS_*`` env channels fire as staged; the
compile injector stops after its count; an injected OOM is a genuine
``torch.cuda.OutOfMemoryError`` of class ``oom``; the failing Cholesky
drives the host jitter ladder and, unbounded, exhausts it."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)

import numpy as np
import pytest
import torch

from spark_gp_tpu.resilience import chaos as j_chaos
from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException, cholesky_escalated
from spark_gp_tpu_torch.resilience import chaos, fallback


@pytest.mark.parametrize("kind", ["nan", "inf", "huge", "dup"])
def test_poison_expert_is_bit_equal_to_jax(kind):
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(203, 4)), rng.normal(size=203)
    for seed in (0, 7):
        tx, ty = chaos.poison_expert(x, y, expert=2, num_experts=9, kind=kind, seed=seed)
        jx, jy = j_chaos.poison_expert(x, y, expert=2, num_experts=9, kind=kind, seed=seed)
        assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()
    assert x.tobytes() == np.random.default_rng(3).normal(size=(203, 4)).tobytes()  # untouched
    with pytest.raises(ValueError):
        chaos.poison_expert(x, y, expert=9, num_experts=9)
    with pytest.raises(ValueError):
        chaos.poison_expert(x, y, expert=0, num_experts=9, kind="zero")


def test_oom_injector_counts_and_filters():
    with chaos.oom_after_calls(2, op="fit.host") as fired:
        chaos.maybe_injected_failure("fit.host")
        chaos.maybe_injected_failure("predict.chunk")  # filtered out, not counted
        chaos.maybe_injected_failure("fit.host")
        with pytest.raises(torch.cuda.OutOfMemoryError) as info:
            chaos.maybe_injected_failure("fit.host")
    assert fired == [1] and fallback.classify_failure(info.value) == fallback.OOM
    chaos.maybe_injected_failure("fit.host")  # unstaged again
    with chaos.oom_after_calls(0, op="predict.chunk", rows_above=100) as fired:
        chaos.maybe_injected_failure("predict.chunk", rows=100)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            chaos.maybe_injected_failure("predict.chunk", rows=101)
    assert fired == [1]
    with pytest.raises(ValueError):
        with chaos.oom_after_calls(-1):
            pass


def test_memory_limit_models_the_allocator():
    with chaos.memory_limit_bytes(1e6) as fired:
        assert chaos.staged_memory_limit() == 1e6
        chaos.maybe_injected_failure("fit.host", nbytes=1e6)
        chaos.maybe_injected_failure("fit.host")  # no byte model: never trips
        with pytest.raises(torch.cuda.OutOfMemoryError, match="CUDA out of memory"):
            chaos.maybe_injected_failure("fit.host", nbytes=1e6 + 1)
    assert fired == [1] and chaos.staged_memory_limit() is None


def test_compile_injector_is_bounded():
    with chaos.failing_compile(2, op="predict") as fired:
        for _ in range(2):
            with pytest.raises(RuntimeError) as info:
                chaos.maybe_injected_failure("predict.chunk")
            assert fallback.classify_failure(info.value) == fallback.COMPILE
        chaos.maybe_injected_failure("predict.chunk")
        chaos.maybe_injected_failure("fit.host")
    assert fired == [2]


def test_env_channels(monkeypatch):
    monkeypatch.setenv("GP_CHAOS_OOM_AFTER_CALLS", "1")
    monkeypatch.setenv("GP_CHAOS_OOM_OP", "fit.host")
    monkeypatch.setenv("GP_CHAOS_OOM_ROWS_ABOVE", "10")
    calls = chaos._state["oom_calls"]
    chaos.maybe_injected_failure("fit.host", rows=11)
    chaos.maybe_injected_failure("fit.host", rows=5)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        chaos.maybe_injected_failure("fit.host", rows=11)
    chaos._state["oom_calls"] = calls
    for name in ("GP_CHAOS_OOM_AFTER_CALLS", "GP_CHAOS_OOM_OP", "GP_CHAOS_OOM_ROWS_ABOVE"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("GP_CHAOS_MEMORY_LIMIT_BYTES", "5000")
    assert chaos.staged_memory_limit() == 5000.0
    with pytest.raises(torch.cuda.OutOfMemoryError):
        chaos.maybe_injected_failure("fit.host", nbytes=5001)
    monkeypatch.delenv("GP_CHAOS_MEMORY_LIMIT_BYTES")
    monkeypatch.setenv("GP_CHAOS_FAILING_COMPILE", "1")
    monkeypatch.setenv("GP_CHAOS_COMPILE_OP", "fit")
    try:
        chaos.maybe_injected_failure("predict.chunk")
        with pytest.raises(RuntimeError, match="during compilation"):
            chaos.maybe_injected_failure("fit.host")
        chaos.maybe_injected_failure("fit.host")  # the env count is spent
    finally:
        chaos._state.update(compile_fail=None, compile_op=None)


def test_failing_cholesky_drives_the_jitter_ladder():
    a = np.random.default_rng(0).normal(size=(6, 6))
    mat = torch.as_tensor(a @ a.T + 6 * np.eye(6))
    with chaos.failing_cholesky(1) as fired:
        chol, tau = cholesky_escalated(mat)
    assert fired == [1] and tau > 0 and torch.isfinite(chol).all()
    with chaos.failing_cholesky(100), pytest.raises(NotPositiveDefiniteException):
        cholesky_escalated(mat)
    chol, tau = cholesky_escalated(mat)
    assert tau == 0.0
