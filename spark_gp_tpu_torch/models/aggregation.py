"""Expert aggregation plane: predict-time weighting and fit-time selection
(the JAX package's ``models/aggregation.py``).

**Predict-time policy** -- ``GP_AGG_POLICY`` in {``poe`` (default, the
plain product), ``gpoe`` (uniform beta = 1/E), ``rbcm`` (entropy-weighted
precisions with the prior correction), ``healed`` (normalized entropy
weights: a convex combination of expert precisions)}.  Resolution order:
:func:`agg_policy_scope` (thread-local), :func:`set_agg_policy`
(process-wide, also ``setAggregationPolicy``), the environment, ``poe``.
The weight formulas live in ``models/poe.py``.

**Fit-time selection** -- ``GP_AGG_SELECT=1`` scores expert redundancy
from order-invariant random-feature sketches of each expert's (x, y)
rows before any objective evaluation, and drops (or, with
``GP_AGG_SELECT_MODE=downweight``, down-weights) the redundant experts.
Drop mode compacts the stack to the kept experts; the weights ride the
fit objectives as the ``weights`` operand through
:func:`weighted_expert_sum`, the one weighted reduction that quarantine
(``w_e = 0`` by masking) and selection share.

The sketches are centered across the stack: round-robin grouping deals
every expert iid rows of one distribution, so raw mean-feature sketches
all converge to the same expectation; the centered residuals of
independent chunks are near-orthogonal, of duplicated chunks near
parallel.  Exactly identical raw sketches are caught separately.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.utils.device import resolve_device

# --------------------------------------------------------------------------
# the aggregation-policy lane
# --------------------------------------------------------------------------

AGG_POLICIES = ("poe", "gpoe", "rbcm", "healed")

_POLICY_OVERRIDE: Optional[str] = None
_SCOPE = threading.local()


def _validate_policy(policy, source: str) -> str:
    policy = str(policy).strip().lower()
    if policy not in AGG_POLICIES:
        raise ValueError(
            f"{source}={policy!r} is not an aggregation policy; use one of "
            f"{sorted(AGG_POLICIES)}"
        )
    return policy


def active_agg_policy() -> str:
    """The policy in effect: the innermost :func:`agg_policy_scope`, else
    the :func:`set_agg_policy` override, else ``GP_AGG_POLICY``, else
    ``poe``."""
    scoped = getattr(_SCOPE, "policy", None)
    if scoped is not None:
        return scoped
    if _POLICY_OVERRIDE is not None:
        return _POLICY_OVERRIDE
    env = os.environ.get("GP_AGG_POLICY")
    if env is None or not env.strip():
        return "poe"
    return _validate_policy(env, "GP_AGG_POLICY")


def set_agg_policy(policy):
    """Process-wide policy setter (the programmatic twin of
    ``GP_AGG_POLICY``); ``None`` clears the override.  Returns the
    previous override."""
    global _POLICY_OVERRIDE
    previous = _POLICY_OVERRIDE
    _POLICY_OVERRIDE = None if policy is None else _validate_policy(policy, "set_agg_policy")
    return previous


def policy_engaged() -> bool:
    """Whether a policy was bound explicitly (scope, override or
    environment): consumers with another default (``poe_predictor``'s
    ``rbcm``) defer to the plane only then."""
    return (
        getattr(_SCOPE, "policy", None) is not None
        or _POLICY_OVERRIDE is not None
        or bool(os.environ.get("GP_AGG_POLICY", "").strip())
    )


def resolve_predictor_mode(mode=None, default: str = "rbcm") -> str:
    """The PoE mode for a ``mode=None`` caller: the engaged policy, else
    ``default``; an explicit ``mode`` passes through (``models/poe.py``
    validates it)."""
    if mode is not None:
        return str(mode)
    return active_agg_policy() if policy_engaged() else default


@contextlib.contextmanager
def agg_policy_scope(policy):
    """Pin the policy for the duration of a block; ``None`` is a no-op."""
    if policy is None:
        yield
        return
    policy = _validate_policy(policy, "agg_policy_scope")
    prev = getattr(_SCOPE, "policy", None)
    _SCOPE.policy = policy
    try:
        yield
    finally:
        _SCOPE.policy = prev


# --------------------------------------------------------------------------
# fit-time correlation-aware expert subset selection
# --------------------------------------------------------------------------


def selection_enabled() -> bool:
    """``GP_AGG_SELECT`` truthy engages fit-time selection; off by default."""
    return os.environ.get("GP_AGG_SELECT", "").strip().lower() in ("1", "on", "true", "yes")


def selection_threshold() -> float:
    """Centered-sketch cosine similarity at or above which two experts
    count as redundant (``GP_AGG_SELECT_THRESHOLD``, default 0.95)."""
    raw = os.environ.get("GP_AGG_SELECT_THRESHOLD", "").strip()
    try:
        return float(raw) if raw else 0.95
    except ValueError:
        return 0.95


def selection_mode() -> str:
    """``drop`` (default): redundant experts leave the stack before any
    factorization.  ``downweight``: every member of a redundancy group of
    size g keeps its data and enters the weighted NLL at ``w_e = 1/g``."""
    raw = os.environ.get("GP_AGG_SELECT_MODE", "").strip().lower()
    if raw in ("", "drop"):
        return "drop"
    if raw == "downweight":
        return "downweight"
    raise ValueError(
        f"GP_AGG_SELECT_MODE={raw!r} is not a selection mode; use 'drop' or 'downweight'"
    )


def sketch_dim() -> int:
    """Random-feature sketch width (``GP_AGG_SKETCH_DIM``, default 64:
    32 cos/sin pairs)."""
    raw = os.environ.get("GP_AGG_SKETCH_DIM", "").strip()
    try:
        return max(4, int(raw)) if raw else 64
    except ValueError:
        return 64


def expert_sketches(data, dim: Optional[int] = None, seed: int = 0, mesh=None) -> np.ndarray:
    """Order-invariant per-expert random-feature sketches ``[E, d]``
    (float64 host numpy): each expert's masked mean of ``[cos(z W),
    sin(z W)]`` over its rows ``z = (x, y)``, standardized against the
    whole stack's masked moments; ``W`` from numpy's ``default_rng(seed)``,
    the JAX package's draws.  Over a ``mesh`` ``data`` is this rank's
    block: the moments are the mesh's (``n`` and ``sum z`` all-reduced,
    then ``sum (z - mu)^2``), and the blocks' sketches are all-gathered
    into the global stack's ``[E, d]`` in expert order, the same on every
    rank."""
    x = data.x.detach().to(torch.float64).cpu().numpy()
    y = data.y.detach().to(torch.float64).cpu().numpy()
    m = data.mask.detach().to(torch.float64).cpu().numpy()
    if y.ndim == 3:  # multi-head latent stacks sketch head 0
        y = y[..., 0]
    z = np.concatenate([x, y[..., None]], axis=-1)  # [E, s, p+1]
    w = m[..., None]
    if mesh is None:
        total = np.concatenate([[w.sum()], (z * w).sum(axis=(0, 1))])
    else:
        total = mesh.all_reduce_host(np.concatenate([[w.sum()], (z * w).sum(axis=(0, 1))]))
    n = max(float(total[0]), 1.0)
    mu = total[1:] / n
    sq = (np.square(z - mu) * w).sum(axis=(0, 1))
    var = (sq if mesh is None else mesh.all_reduce_host(sq)) / n
    z = (z - mu) / np.sqrt(var + 1e-12)
    half = max(2, (dim if dim is not None else sketch_dim()) // 2)
    rng = np.random.default_rng(seed)
    freqs = rng.normal(size=(z.shape[-1], half))
    proj = z @ freqs  # [E, s, half]
    feats = np.concatenate([np.cos(proj), np.sin(proj)], axis=-1)
    n_e = np.maximum(m.sum(axis=1), 1.0)[:, None]
    sketches = (feats * w).sum(axis=1) / n_e  # [E, 2 * half]
    return sketches if mesh is None else _gathered(sketches, mesh)


def _gathered(block: np.ndarray, mesh) -> np.ndarray:
    """Every rank's ``[E_block, ...]`` float64 ``block`` in rank order (the
    global expert order), through the mesh's device."""
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.as_tensor(np.ascontiguousarray(block), dtype=torch.float64, device=dev)
    return torch.cat(mesh.all_gather(t)).cpu().numpy()


def redundancy_matrix_host(sketches: np.ndarray) -> np.ndarray:
    """Host-numpy redundancy scorer, the plain version of
    :func:`redundancy_matrix` that the tests hold it against."""
    s = np.asarray(sketches, dtype=np.float64)
    resid = s - s.mean(axis=0, keepdims=True)
    norms = np.linalg.norm(resid, axis=1)
    floor = 1e-12 + 1e-9 * np.linalg.norm(s, axis=1)
    unit = resid / np.maximum(norms, floor)[:, None]
    sim = unit @ unit.T
    # raw-identity catch: ||s_i - s_j||^2 through the gram
    sq = np.sum(np.square(s), axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (s @ s.T), 0.0)
    scale = np.maximum(np.maximum(sq[:, None], sq[None, :]), 1e-24)
    sim = np.where(d2 <= 1e-12 * scale, 1.0, sim)
    np.fill_diagonal(sim, 1.0)
    return sim


def redundancy_matrix(sketches, device=None) -> np.ndarray:
    """``[E, E]`` pairwise redundancy scores in [-1, 1], in float64 on
    ``device`` (the stack's; ``None`` means ``"cuda"``): the cosine similarity of the across-stack
    centered sketches, with (near-)identical raw sketches forced to 1.0
    (when nearly every expert is one duplicate class the centered
    residuals cancel and the cosine alone would miss them)."""
    s = torch.as_tensor(np.asarray(sketches, dtype=np.float64), device=resolve_device(device))
    resid = s - s.mean(dim=0, keepdim=True)
    norms = torch.linalg.norm(resid, dim=1)
    floor = 1e-12 + 1e-9 * torch.linalg.norm(s, dim=1)
    unit = resid / torch.maximum(norms, floor)[:, None]
    sim = unit @ unit.T
    sq = torch.sum(s * s, dim=1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (s @ s.T), 0.0)
    scale = torch.clamp_min(torch.maximum(sq[:, None], sq[None, :]), 1e-24)
    sim = torch.where(d2 <= 1e-12 * scale, torch.ones_like(sim), sim)
    sim.fill_diagonal_(1.0)
    return sim.cpu().numpy()


@dataclass(frozen=True)
class SelectionReport:
    """Outcome of one correlation-aware selection pass over the stack."""

    drop: np.ndarray      # bool [E] -- redundant, masked out (drop mode)
    weights: np.ndarray   # f64 [E] -- post-selection per-expert weights
    num_active: int       # experts with any unmasked point beforehand
    mode: str             # 'drop' | 'downweight'
    threshold: float

    @property
    def num_dropped(self) -> int:
        return int(self.drop.sum())

    @property
    def num_kept(self) -> int:
        return self.num_active - self.num_dropped

    @property
    def renorm(self) -> float:
        """``E_active / sum(w)``; 1.0 when selection changed nothing."""
        return weighted_renorm_factor(self.weights, self.num_active)

    @property
    def clean(self) -> bool:
        return self.num_dropped == 0 and bool(np.all(self.weights[self.weights > 0] == 1.0))


def weighted_renorm_factor(weights, active: float) -> float:
    """``E_active / sum(w_e)``: :func:`quarantine.renorm_factor`
    generalized to per-expert weights (unit weights with d drops give
    ``active / (active - d)``); raises the same
    :class:`~spark_gp_tpu_torch.resilience.quarantine.ExpertQuarantineError`
    when no weight remains."""
    from spark_gp_tpu_torch.resilience.quarantine import (
        GLOBAL_FAILURE_ADVICE,
        ExpertQuarantineError,
    )

    total = float(np.sum(np.asarray(weights, dtype=np.float64)))
    if total <= 0:
        raise ExpertQuarantineError(
            f"aggregation weights sum to {total} over {int(active)} active "
            "expert(s) — " + GLOBAL_FAILURE_ADVICE
        )
    return float(active) / total


def effective_expert_count(weights) -> float:
    """Participation ratio ``(sum w)^2 / sum w^2``: E for uniform weights,
    1.0 when one expert carries everything, 0.0 for no weight."""
    w = np.asarray(weights, dtype=np.float64)
    denom = float(np.sum(np.square(w)))
    if denom <= 0:
        return 0.0
    return float(np.square(np.sum(w)) / denom)


def select_experts(data, threshold: Optional[float] = None, mode: Optional[str] = None,
                   seed: int = 0, mesh=None, num_experts: Optional[int] = None) -> SelectionReport:
    """Score redundancy and pick the expert subset, first kept first:
    walking the stack in order, each kept expert claims every unclaimed
    expert whose similarity reaches the threshold; claimed experts are
    dropped (``drop``) or every member of the group is down-weighted to
    1/|group| (``downweight``).  Fully masked experts stay at ``w_e = 0``
    and claim no one.

    Over a ``mesh`` ``data`` is this rank's block, and the report is the
    global stack's, the same on every rank: the sketches are the mesh's
    (:func:`expert_sketches`), every rank scores and walks the same matrix.
    ``num_experts`` is the stack's count before the mesh's padding (its
    tail: ``parallel/mesh.shard_experts``): only those experts are scored,
    so the report is the unsharded stack's; the padded experts' entries
    are inactive (kept, weight 0)."""
    mask = data.mask.detach().to(torch.float64).cpu().numpy()
    if mesh is not None:
        mask = _gathered(mask, mesh)
    active = mask.sum(axis=1) > 0
    e_all = mask.shape[0]
    e = e_all if num_experts is None else int(num_experts)
    thr = selection_threshold() if threshold is None else float(threshold)
    mode = selection_mode() if mode is None else str(mode)
    sketches = expert_sketches(data, seed=seed, mesh=mesh)[:e]
    sim = redundancy_matrix(sketches, device=data.x.device)
    active[e:] = False
    drop = np.zeros(e_all, dtype=bool)
    weights = np.where(active, 1.0, 0.0)
    claimed = ~active
    for i in range(e):
        if claimed[i]:
            continue
        claimed[i] = True
        dups = np.flatnonzero((sim[i] >= thr) & ~claimed[:e])
        claimed[dups] = True
        if dups.size == 0:
            continue
        if mode == "drop":
            drop[dups] = True
            weights[dups] = 0.0
        else:
            group_w = 1.0 / (1.0 + dups.size)
            weights[i] = group_w
            weights[dups] = group_w
    return SelectionReport(drop=drop, weights=weights, num_active=int(active.sum()),
                           mode=mode, threshold=thr)


# --------------------------------------------------------------------------
# the one weighted reduction the fit objectives share
# --------------------------------------------------------------------------


def weighted_expert_sum(per_expert: torch.Tensor, weights=None) -> torch.Tensor:
    """``sum_e w_e v_e`` over a ``[E, ...]`` per-expert tensor, reducing
    every axis: the marginal NLL, the LOO pseudo-likelihood and the
    Laplace families' evidence sums share it.  ``weights=None`` is the
    plain ``torch.sum``."""
    if weights is None:
        return torch.sum(per_expert)
    w = torch.as_tensor(weights, dtype=per_expert.dtype, device=per_expert.device)
    return torch.sum(w.reshape(w.shape + (1,) * (per_expert.ndim - 1)) * per_expert)
