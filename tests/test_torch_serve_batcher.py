"""The port's shape-bucketed predictor (``serve/batcher.py``): the JAX
package's batcher cases (bucket ladder, exact boundaries, no padding
leak, one build per bucket, the guard, chunking, mean-only, validation)
on the CPU, where a bucket's first eager run is its build; the card's
branch failing its capture or replay with typed errors; and parity with
the JAX ``BucketedPredictor`` on the same fields (float64, rel 1e-10)."""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import numpy as np
import pytest
import torch

import spark_gp_tpu as jgp
import spark_gp_tpu_torch as tgp
from spark_gp_tpu.models.ppa import ProjectedProcessRawPredictor as JRaw
from spark_gp_tpu.serve.batcher import BucketedPredictor as JBucketed
from spark_gp_tpu_torch.obs.runtime import telemetry
from spark_gp_tpu_torch.resilience import memplan
from spark_gp_tpu_torch.serve.batcher import (
    BucketedPredictor,
    BucketOverflowError,
    GraphCaptureError,
    GraphReplayError,
    RecompileGuardError,
    _BucketGraph,
    bucket_sizes,
)


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 3))
    y = np.sin(x.sum(axis=1)) + 0.05 * rng.normal(size=200)
    model = (
        tgp.GaussianProcessRegression(device="cpu")
        .setKernel(lambda: tgp.RBFKernel(1.0))
        .setDatasetSizeForExpert(40).setActiveSetSize(40).setSigma2(1e-3)
        .setMaxIter(8).setSeed(5).fit(x, y)
    )
    return model, x


def test_bucket_ladder_and_boundaries():
    assert bucket_sizes(256, 8) == (8, 16, 32, 64, 128, 256)
    assert bucket_sizes(100, 3) == (4, 8, 16, 32, 64, 128)
    assert bucket_sizes(1, 1) == (1,)
    with pytest.raises(ValueError):
        bucket_sizes(4, 32)
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_bucket_for_exact_boundaries(fitted):
    model, _ = fitted
    bp = BucketedPredictor(model.raw_predictor, max_batch=64, min_bucket=8)
    assert bp.buckets == (8, 16, 32, 64) and not bp.uses_graphs
    assert [bp.bucket_for(n) for n in (1, 8, 9, 16, 17, 64, 65)] == [8, 8, 16, 16, 32, 64, None]
    assert [bp.padded_rows(t) for t in (0, 1, 64, 65, 130)] == [0, 8, 64, 72, 136]


def test_padding_never_leaks_into_results(fitted):
    model, x = fitted
    raw = model.raw_predictor
    bp = BucketedPredictor(raw, max_batch=64, min_bucket=8)
    bp.warmup()
    for t in (1, 7, 8, 9, 15, 16, 17, 31, 32, 63, 64, 65, 100, 150):
        mean, var = bp.predict(x[:t])
        ref_mean, ref_var = raw(x[:t])
        assert mean.shape == (t,) and var.shape == (t,)
        np.testing.assert_allclose(mean, ref_mean.numpy(), rtol=1e-10)
        np.testing.assert_allclose(var, ref_var.numpy(), rtol=1e-10)


def test_one_build_per_bucket_under_mixed_traffic(fitted):
    model, x = fitted
    before = telemetry.snapshot()["counters"].get("compile.bucket_traces", 0.0)
    bp = BucketedPredictor(model.raw_predictor, max_batch=64, min_bucket=8)
    counts = bp.warmup()
    assert counts == {8: 1, 16: 1, 32: 1, 64: 1}
    rng = np.random.default_rng(0)
    for t in rng.integers(1, 65, size=50):
        bp.predict(x[: int(t)])
    # a float32 payload is cast on entry: no second family of builds
    bp.predict(x[:10].astype(np.float32))
    assert bp.compile_counts == {8: 1, 16: 1, 32: 1, 64: 1}
    assert bp.total_compiles == len(bp.buckets)
    assert telemetry.snapshot()["counters"]["compile.bucket_traces"] == before + 4


def test_recompile_guard_fires_on_unwarmed_bucket(fitted):
    model, x = fitted
    bp = BucketedPredictor(model.raw_predictor, buckets=(8, 16))
    bp.warmup()
    bp.predict(x[:5])
    bp.buckets = (8, 16, 32)  # a ladder widened after warmup
    with pytest.raises(RecompileGuardError, match="not warmed"):
        bp.predict(x[:20])


def test_oversize_chunking_and_overflow_error(fitted):
    model, x = fitted
    bp = BucketedPredictor(model.raw_predictor, max_batch=32, min_bucket=8)
    bp.warmup()
    mean, _ = bp.predict(x[:150])
    np.testing.assert_allclose(mean, model.raw_predictor.predict_mean(x[:150]).numpy(), rtol=1e-10)
    assert bp.compile_counts == {8: 1, 16: 1, 32: 1}
    with pytest.raises(BucketOverflowError, match="exceeds the largest"):
        bp.predict(x[:150], chunk_oversize=False)


def test_mean_only_mode_and_release(fitted):
    model, x = fitted
    bp = BucketedPredictor(model.raw_predictor, max_batch=16, min_bucket=8, mean_only=True)
    bp.warmup()
    mean, var = bp.predict(x[:10])
    assert var is None
    np.testing.assert_allclose(mean, model.predict(x[:10]), rtol=1e-10)
    bp.release()
    with pytest.raises(RuntimeError, match="released"):
        bp.predict(x[:3])


def test_input_validation_and_request_sizing(fitted):
    model, x = fitted
    bp = BucketedPredictor(model.raw_predictor, max_batch=16)
    with pytest.raises(ValueError, match=r"\[t, 3\]"):
        bp.predict(x[:4, :2])
    mean, var = bp.predict(np.zeros((0, 3)))
    assert mean.shape == (0,) and var.shape == (0,)
    assert bp.dtype == np.float64
    # sized at the padded bucket: 5 rows cost what 8 do
    assert memplan.predict_request_bytes(bp, 5) == memplan.predict_request_bytes(bp, 8)
    assert memplan.predict_request_bytes(bp, 9) > memplan.predict_request_bytes(bp, 8)


def test_graph_body_is_the_predict_block(fitted, monkeypatch):
    """The bucket body is the predictor's ``_predict_block``, called with
    the uploaded operands (theta and the active set in the working dtype,
    the magic operands in float64) on a padded bucket."""
    model, x = fitted
    seen = []
    original = type(model.raw_predictor)._predict_block

    def spy(self, theta, active, mv, mm, part):
        seen.append((theta.dtype, active.dtype, mv.dtype, mm.dtype, tuple(part.shape)))
        return original(self, theta, active, mv, mm, part)

    monkeypatch.setattr(type(model.raw_predictor), "_predict_block", spy)
    BucketedPredictor(model.raw_predictor, buckets=(8,)).predict(x[:3])
    assert seen == [(torch.float64, torch.float64, torch.float64, torch.float64, (8, 3))]


def test_a_failed_capture_raises_and_never_runs_eager(fitted, monkeypatch):
    """The card's branch with its capture failing (a CUDA stream call that
    raises): a typed error, no eager run, no build counted."""
    model, x = fitted
    bp = BucketedPredictor(model.raw_predictor, buckets=(8,))
    bp.uses_graphs = True
    ran = []
    monkeypatch.setattr(bp, "_body", lambda part: ran.append(part))

    def capture_fails(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "Stream", capture_fails)
    with pytest.raises(GraphCaptureError, match="bucket 8"):
        bp.predict(x[:3])
    assert ran == [] and bp.compile_counts == {}


def test_a_failed_replay_raises_typed(fitted):
    model, x = fitted
    bp = BucketedPredictor(model.raw_predictor, buckets=(8,))
    bp.uses_graphs = True

    class Broken:
        def replay(self):
            raise RuntimeError("an illegal memory access was encountered")

    bp._graphs[8] = _BucketGraph(Broken(), torch.zeros(8, 3, dtype=torch.float64),
                                 torch.zeros(8), torch.zeros(8))
    with pytest.raises(GraphReplayError, match="illegal memory access"):
        bp.predict(x[:3])


@pytest.mark.parametrize("kind", ["regression", "multiclass"])
def test_matches_the_jax_bucketed_predictor(kind):
    rng = np.random.default_rng(11)
    m, p = 24, 3
    fields = {
        "theta": np.array([1.3, 0.6, 0.9, 1.1, 1e-3]),
        "active": rng.normal(size=(m, p)),
        "magic_vector": rng.normal(size=(m, 4) if kind == "multiclass" else m),
        "magic_matrix": -(lambda a: a @ a.T)(rng.normal(size=(m, m)) * 0.1),
    }

    def kernel(mod):
        return 1.0 * mod.ARDRBFKernel(p, 0.7) + mod.Const(1e-3) * mod.EyeKernel()

    from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor as TRaw

    jbp = JBucketed(JRaw(kernel=kernel(jgp), **fields), max_batch=32, min_bucket=8)
    tbp = BucketedPredictor(TRaw(kernel=kernel(tgp), device="cpu", **fields), max_batch=32,
                            min_bucket=8)
    assert tbp.warmup() == jbp.warmup()
    x = rng.normal(size=(80, p))
    for t in (1, 8, 13, 32, 33, 80):
        jm, jv = jbp.predict(x[:t])
        tm, tv = tbp.predict(x[:t])
        assert tm.shape == np.asarray(jm).shape
        for a, b in ((tm, jm), (tv, jv)):
            b = np.asarray(b)
            assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-10
