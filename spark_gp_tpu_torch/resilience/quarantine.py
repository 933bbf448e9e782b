"""Expert quarantine: repair or removal of poisoned BCM experts.

The training objective is ``sum_e NLL_e`` over the expert stack
(``models/likelihood.py``), so one expert whose NLL or gradient is
non-finite -- NaN rows from a bad shard, a gram past the edge of
positive definiteness -- poisons the whole objective.  The recovery
ladder, driven from the host around the objective:

1. **health probe** -- every expert's NLL and gradient, each expert on
   its own one-expert stack, at the initial hyperparameters;
2. **jitter escalation** -- unhealthy experts retry with per-expert
   trace-relative diagonal boosts up ``ops.linalg.JITTER_SCHEDULE``
   through the marginal objective's ``jitter`` operand;
3. **quarantine** -- experts still non-finite after the ladder are made
   inert (``ExpertData.with_experts_masked``); the full-stack-comparable
   objective is ``final_nll * E_active / E_kept``
   (``models/common._log_renormalized_nll``).

Shapes never change.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_gp_tpu_torch.ops.linalg import JITTER_SCHEDULE
from spark_gp_tpu_torch.parallel.experts import ExpertData


class NonFiniteFitError(RuntimeError):
    """A fit attempt produced a non-finite objective (detected on host)."""


class ExpertQuarantineError(RuntimeError):
    """Quarantine would drop every expert: the failure is global, not a
    per-expert fault, and the model configuration itself is numerically
    unusable (the classic remedy: increase sigma2)."""


#: the tail of every "quarantine refused" message
GLOBAL_FAILURE_ADVICE = (
    "the failure is global (increase sigma2 / check the data), not a "
    "quarantinable per-expert fault"
)


def renorm_factor(active: float, dropped: float) -> float:
    """``E_active / E_kept``, the factor mapping the reduced BCM sum back
    to a full-stack-comparable NLL: 1.0 when nothing is dropped; raises
    :class:`ExpertQuarantineError` when nothing would be kept.  The
    aggregation plane generalizes it to per-expert weights
    (``models/aggregation.weighted_renorm_factor``)."""
    kept = active - dropped
    if kept <= 0:
        raise ExpertQuarantineError(
            f"all {int(active)} active expert(s) are non-finite — "
            + GLOBAL_FAILURE_ADVICE
        )
    return active / kept


@dataclass(frozen=True)
class QuarantineReport:
    """Outcome of one diagnosis pass over the expert stack."""

    bad: np.ndarray      # bool [E] -- non-finite after the whole ladder
    jitter: np.ndarray   # f64 [E] -- the relative jitter that fixed each expert
    num_active: int      # experts with any unmasked point before diagnosis

    @property
    def num_dropped(self) -> int:
        return int(self.bad.sum())

    @property
    def num_jittered(self) -> int:
        return int((self.jitter > 0).sum())

    @property
    def renorm(self) -> float:
        """``E_active / E_kept``; 1.0 when nothing is dropped."""
        return renorm_factor(self.num_active, self.num_dropped)

    @property
    def clean(self) -> bool:
        return self.num_dropped == 0 and self.num_jittered == 0


def nonfinite_expert_mask(data: ExpertData) -> np.ndarray:
    """bool [E]: experts with a non-finite unmasked feature or label."""
    real = data.mask > 0
    bad_x = torch.any(~torch.isfinite(data.x) & real[..., None], dim=-1).any(dim=-1)
    bad_y = torch.any(~torch.isfinite(data.y) & real, dim=-1)
    return (bad_x | bad_y).cpu().numpy()


def expert_health(kernel, theta, data: ExpertData, objective: str = "marginal",
                  jitter=None, experts=None):
    """``(nll, grad_l1)`` in float64 numpy, one entry per probed expert
    (``experts``, an index sequence; ``None`` probes all ``E``): each
    expert on its own one-expert stack, value and theta-gradient of
    ``objective`` (each expert a separate graph, so one expert's NaN
    cannot reach another's gradient through the shared theta).
    ``jitter`` (scalar or [E], trace-relative) is the marginal
    objective's escalation operand."""
    from spark_gp_tpu_torch.models.likelihood import objective_fn

    e = data.num_experts
    dtype, device = data.x.dtype, data.x.device
    fn = objective_fn(objective)
    jit = np.broadcast_to(np.asarray(0.0 if jitter is None else jitter, np.float64), (e,))
    theta0 = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=dtype, device=device)
    rows = []
    for i in range(e) if experts is None else experts:
        local = ExpertData(x=data.x[i:i + 1], y=data.y[i:i + 1], mask=data.mask[i:i + 1])
        t = theta0.clone().requires_grad_(True)
        extra = ((torch.as_tensor(jit[i], dtype=dtype, device=device),)
                 if objective == "marginal" else ())
        value = fn(kernel, t, local, None, *extra)
        (grad,) = torch.autograd.grad(value, t)
        rows.append(torch.stack([value.detach(), torch.sum(torch.abs(grad))]))
    host = torch.stack(rows).to(torch.float64).cpu().numpy()
    return host[:, 0], host[:, 1]


#: the fit-time expert-quality probes' kernel launches in this process,
#: by kernel: the sum of every fit's ``expert_quality.probe_launches.<kernel>``
#: stamps (``models/common._emit_expert_quality``), which a launch count
#: over many fits states as its probe term
PROBE_LAUNCHES: dict = {}


def expert_nll(kernel, theta, data: ExpertData, jitter=None, cache=None) -> np.ndarray:
    """``[E]`` float64 numpy: every expert's marginal NLL at ``theta``
    unsummed, in ONE pass over the ``[E, s, ...]`` stack on the solver
    lane in effect (``models/likelihood.batched_nll(reduce=False)``): one
    K1 launch over ``[E, s, s]`` on the card's exact lane, the CG engine's
    per-expert estimate on the iterative lane, K2 and the quadrature with
    no ``[E, s, s]`` stack on the matfree lane.  ``jitter`` (scalar or
    ``[E]``, trace-relative) is the recovery's per-expert ridge.  No
    gradient is taken (the JAX package's vmapped probe discards it), so
    one expert's NaN stays in its own entry; :func:`expert_health` keeps
    its per-expert graphs for the gradients the diagnosis needs.  The
    fit-time expert-quality probe (``models/common._emit_expert_quality``)."""
    from spark_gp_tpu_torch.models.likelihood import batched_nll

    dtype, device = data.x.dtype, data.x.device
    theta_t = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=dtype, device=device)
    jit = None
    if jitter is not None:
        jit = torch.as_tensor(
            np.broadcast_to(np.asarray(jitter, np.float64), (data.num_experts,)).copy(),
            dtype=dtype, device=device)
    with torch.no_grad():
        nll = batched_nll(kernel, theta_t, data, cache, jit, reduce=False)
    return nll.to(torch.float64).cpu().numpy()


def _healthy(nll: np.ndarray, gnorm: np.ndarray) -> np.ndarray:
    return np.isfinite(nll) & np.isfinite(gnorm)


def diagnose_experts(kernel, theta, data: ExpertData, objective: str = "marginal",
                     schedule=JITTER_SCHEDULE, allow_jitter: bool = True) -> QuarantineReport:
    """Probe every expert, escalate jitter for the unhealthy, report.

    Healthy experts keep jitter 0; an unhealthy one walks the ladder rung
    by rung and keeps the first rung that makes it finite; experts the
    whole ladder cannot repair are ``bad``.  A rung re-probes only the
    experts still unhealthy.  Only the marginal objective carries the
    jitter operand, so other objectives (and ``allow_jitter=False``) go
    from the unjittered probe to quarantine."""
    e = data.num_experts
    active = data.mask.sum(dim=1).cpu().numpy() > 0
    nll, gnorm = expert_health(kernel, theta, data, objective)
    healthy = _healthy(nll, gnorm) | ~active  # inert experts are fine
    jitter = np.zeros(e, dtype=np.float64)
    if allow_jitter and objective == "marginal" and not healthy.all():
        for tau in schedule[1:]:
            sick = np.flatnonzero(~healthy)
            nll_t, gnorm_t = expert_health(kernel, theta, data, objective, jitter=tau,
                                           experts=sick)
            fixed = sick[_healthy(nll_t, gnorm_t)]
            jitter[fixed] = tau
            healthy[fixed] = True
            if healthy.all():
                break
    return QuarantineReport(bad=(~healthy) & active, jitter=jitter,
                            num_active=int(active.sum()))


def quarantine_experts(data: ExpertData, bad) -> ExpertData:
    """The stack with the ``bad`` experts made inert
    (``ExpertData.with_experts_masked``); raises
    :class:`ExpertQuarantineError` when every expert is bad."""
    bad = np.asarray(bad, dtype=bool)
    if not bad.any():
        return data
    if bad.all():
        raise ExpertQuarantineError("every expert is non-finite — " + GLOBAL_FAILURE_ADVICE)
    return data.with_experts_masked(bad)
