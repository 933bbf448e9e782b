"""Fault tolerance for the fit: the JAX package's ``resilience`` package.

The BCM objective is a sum of per-expert NLLs, so one poisoned expert
chunk (a NaN feature row, an ill-conditioned gram) makes the whole
objective non-finite.  This package is the recovery layer, outside the
objective's hot path: a clean fit never pays for it, and a failed one is
retried with repaired operands.

* :mod:`~spark_gp_tpu_torch.resilience.quarantine` -- per-expert health
  probes, jitter escalation over ``ops.linalg.JITTER_SCHEDULE``, and
  quarantine with renormalization for experts the ladder cannot repair.
* :mod:`~spark_gp_tpu_torch.resilience.retry` -- bounded retry with
  backoff for whole fit attempts.
* :mod:`~spark_gp_tpu_torch.resilience.fallback` -- the closed failure
  taxonomy and the fit and predict degradation ladders around a whole
  attempt.
* :mod:`~spark_gp_tpu_torch.resilience.memplan` -- the device budget, the
  byte models of each lane and the plan decisions (the budget-aware
  ``auto`` lane, the predict chunk).
* :mod:`~spark_gp_tpu_torch.resilience.chaos` -- deterministic fault
  injection for the fit and predict paths.
"""

from spark_gp_tpu_torch.resilience.quarantine import (
    ExpertQuarantineError,
    NonFiniteFitError,
    QuarantineReport,
    diagnose_experts,
    expert_health,
    nonfinite_expert_mask,
    quarantine_experts,
)
from spark_gp_tpu_torch.resilience.retry import RetryBudgetExceededError, retry_with_backoff

__all__ = [
    "ExpertQuarantineError",
    "NonFiniteFitError",
    "QuarantineReport",
    "RetryBudgetExceededError",
    "diagnose_experts",
    "expert_health",
    "nonfinite_expert_mask",
    "quarantine_experts",
    "retry_with_backoff",
]
