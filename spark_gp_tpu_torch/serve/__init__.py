"""Online inference on one process (the port's counterpart of the JAX
package's ``serve`` package, single-replica half).

The PPA predictor's cost depends only on the m-point active set
(``models/ppa.py``), the shape of a low-latency scorer.  What serving adds
to a correct ``predict`` is shape discipline: free-form request sizes
would pay the eager path's per-operation launches on every request.  This
package keeps a finite, warm set of captured programs:

* :class:`~spark_gp_tpu_torch.serve.registry.ModelRegistry` -- ``.npz``
  models of either package (``utils/serialization.py``) keyed by name and
  version, hot-swapped on reload;
* :class:`~spark_gp_tpu_torch.serve.batcher.BucketedPredictor` -- requests
  padded to power-of-two buckets, one CUDA graph per (model, bucket)
  captured at warmup, with a guard against builds after it;
* :class:`~spark_gp_tpu_torch.serve.server.GPServeServer` -- a bounded
  queue with micro-batch coalescing, per-request deadlines, load shedding,
  per-model circuit breakers, a hang watchdog, memory admission, canary
  rollouts and graceful drain (``serve/lifecycle.py``);
* :class:`~spark_gp_tpu_torch.serve.metrics.ServingMetrics` -- counters,
  gauges and latency histograms, on the OpenMetrics page
  (``obs/expo.py``);
* ``python -m spark_gp_tpu_torch.serve`` -- the JSON-lines CLI (stdin or
  localhost TCP) that warms every bucket before it reports ready.

The statistical quality plane (``observe``, calibration and drift
monitors, ``obs/quality.py``) is on by default; the multi-replica fleet
is ROADMAP.md queue 1, item 10c.
"""

from spark_gp_tpu_torch.resilience.breaker import BreakerOpenError, CircuitBreaker
from spark_gp_tpu_torch.serve.batcher import (
    BucketedPredictor,
    BucketOverflowError,
    GraphCaptureError,
    GraphReplayError,
    RecompileGuardError,
    bucket_sizes,
)
from spark_gp_tpu_torch.serve.lifecycle import (
    CanaryPolicy,
    DrainingError,
    ExecHungError,
    HangWatchdog,
    MemoryAdmissionGate,
    MemoryPressureError,
)
from spark_gp_tpu_torch.serve.metrics import LatencyHistogram, ServingMetrics
from spark_gp_tpu_torch.serve.queue import (
    DeadlineExpiredError,
    QueueFullError,
    RequestTimeoutError,
    ServeFuture,
)
from spark_gp_tpu_torch.serve.registry import ModelRegistry, ServableModel
from spark_gp_tpu_torch.serve.server import GPServeServer

__all__ = [
    "BreakerOpenError",
    "BucketedPredictor",
    "BucketOverflowError",
    "CanaryPolicy",
    "CircuitBreaker",
    "DeadlineExpiredError",
    "DrainingError",
    "ExecHungError",
    "GraphCaptureError",
    "GraphReplayError",
    "HangWatchdog",
    "MemoryAdmissionGate",
    "MemoryPressureError",
    "RecompileGuardError",
    "bucket_sizes",
    "ServingMetrics",
    "LatencyHistogram",
    "QueueFullError",
    "RequestTimeoutError",
    "ServeFuture",
    "ModelRegistry",
    "ServableModel",
    "GPServeServer",
]
