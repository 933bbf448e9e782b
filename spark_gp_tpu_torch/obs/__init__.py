"""Observability of the port's fits (the JAX package's ``obs`` package).

* :mod:`~spark_gp_tpu_torch.obs.trace` -- context-var span tracer: a fit
  renders as one tree (root ``fit.<Family>``, one span per phase), kept
  in a ring buffer; JSONL and Chrome/Perfetto ``trace_event`` exports.
* :mod:`~spark_gp_tpu_torch.obs.runtime` -- kernel builds and launches
  per entry point, memory gauges sampled at phase boundaries, and the
  per-fit ``run_journal``.
* :mod:`~spark_gp_tpu_torch.obs.recorder` -- the flight recorder and the
  incident bundles dumped on terminal classified failures.
* :mod:`~spark_gp_tpu_torch.obs.cost` -- cost attribution: metered flops
  and bytes per entry point (``GP_XLA_COST``), the library operations
  under a dispatch counter once a signature and the kernels' work models
  at every launch; the journal's ``xla_cost`` and
  ``gp_xla_flops_total{entry=...}``.
* :mod:`~spark_gp_tpu_torch.obs.quality` -- the statistical quality
  plane: calibration and drift monitors, the pending ring behind the
  serve ``observe`` verb, the covariate summary.
* :mod:`~spark_gp_tpu_torch.obs.expo` -- the OpenMetrics page of a fit's
  ``Instrumentation`` and the telemetry.
* :mod:`~spark_gp_tpu_torch.obs.names` -- the catalog of every emitted
  key, and :func:`~spark_gp_tpu_torch.obs.names.check_package`, the lint
  that holds the package to it.
"""

from spark_gp_tpu_torch.obs.expo import render_openmetrics  # noqa: F401
from spark_gp_tpu_torch.obs.recorder import (  # noqa: F401
    RECORDER,
    dump_incident,
    recording_enabled,
    set_recording,
)
from spark_gp_tpu_torch.obs.runtime import (  # noqa: F401
    build_info,
    telemetry,
    write_run_journal,
)
from spark_gp_tpu_torch.obs.trace import (  # noqa: F401
    add_event,
    current_span,
    set_tracing,
    span,
    tracing_enabled,
)
