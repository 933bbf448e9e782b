"""Iterative expert inference: the batched CG / Lanczos solver lanes, the
port of the JAX package's ``ops/iterative.py`` (regression and the binary
classifier's B-system solvers).

The exact lane pays a batched ``[E, s, s]`` factorization per objective
evaluation; past a few hundred rows per expert that factorization (and,
on the matfree lane, the gram stack itself) is the cost.  Following
GPyTorch's blackbox matrix-matrix inference (arXiv 1809.11165) this
module expresses the marginal NLL's two terms through products alone:

* **batched preconditioned conjugate gradients** over the whole stack,
  multi-RHS so the solve against ``y`` and the probe vectors share one
  product per step (:func:`batched_pcg`), with a fixed trip count and
  converged columns frozen by ``torch.where`` -- no host sync in the loop;
* a **partial pivoted-Cholesky preconditioner** of rank ``k << s``,
  built from a column oracle (:func:`pivoted_cholesky_cols`) and applied
  through the Woodbury identity; its exact log-determinant anchors the
  log-det estimate;
* **stochastic Lanczos quadrature** for the log-det from the PCG
  coefficients (:func:`slq_logdet_from_coeffs`; on the card the quadrature
  of each probe's tridiagonal is the hand-written kernel of
  ``ops/slq_quadrature.py``), with the Hutchinson surrogate
  ``mean_i v_i^T K u_i`` carrying its gradient.

Nothing in the engine reads the device from the host, so the device
optimizer's captured step holds it (``models/likelihood.py``,
``models/laplace_device.py``): the PCG loop has a fixed trip count, the
pivoted Cholesky keeps its pivots on the device, and a device fit's probes
come from a :class:`ProbeSet` drawn at its first (eager) evaluation.

No autograd traverses the CG loop: the quadratic term is the CG
iterate's variational value ``2 a^T y - a^T K a`` with ``a`` detached
(exact gradient ``-a a^T``), and the log-det is
``(slq - surr).detach() + surr``.  Only two products of the operator are
differentiated per evaluation.

:func:`inv_quad_logdet_matfree` takes the operator as closures -- the
matfree lane streams every product through ``ops/streamed_matvec.py`` and
never builds the gram -- and :func:`inv_quad_logdet` runs the same
engine on a materialized stack (``torch`` matmuls).  :func:`spd_solve`
and :func:`spd_logdet` solve and take the log-det of the binary Laplace
classifier's ``B`` systems on the same preconditioner and engine;
:func:`factored_solve` and :func:`factored_logdet` those of the
multiclass classifier, ``I + S^T K_blk S``, applied through per-class
products and never materialized.

Lane selection: ``GP_SOLVER_LANE`` in {``exact``, ``iterative``,
``matfree``, ``auto``}, :func:`set_solver_lane` (process-wide),
:func:`solver_lane_scope` (thread-local), default ``exact``.  ``auto``
switches to ``iterative`` when the expert size reaches
``GP_SOLVER_AUTO_THRESHOLD`` (default 1024), and to ``matfree`` there
when the memory planner (``resilience/memplan.py``) prices the
materialized iterative program over the device budget.  Knobs, read when an objective is built:
``GP_SOLVER_MAX_ITERS`` (default ``min(s, 64)``), ``GP_SOLVER_PROBES``
(8), ``GP_SOLVER_PRECOND_RANK`` (``min(s, 64)``), ``GP_SOLVER_CG_TOL``
(1e-5), ``GP_SOLVER_SEED`` (0; the probes are drawn from it at every
evaluation, or once a fit under :func:`probe_scope`, the same numbers
either way, so the objective is a deterministic surrogate).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from spark_gp_tpu_torch.ops.linalg import chol_solve, cholesky

# --------------------------------------------------------------------------
# the solver-lane policy
# --------------------------------------------------------------------------

SOLVER_LANES = ("exact", "iterative", "matfree", "auto")

_LANE_OVERRIDE: Optional[str] = None
_SCOPE = threading.local()


def _validate_lane(lane, source: str) -> str:
    lane = str(lane).strip().lower()
    if lane not in SOLVER_LANES:
        raise ValueError(
            f"{source}={lane!r} is not a solver lane; use one of "
            f"{sorted(SOLVER_LANES)}"
        )
    return lane


def active_solver_lane() -> str:
    """The lane in effect: innermost :func:`solver_lane_scope`, else the
    :func:`set_solver_lane` process override, else ``GP_SOLVER_LANE``,
    else ``exact``."""
    scoped = getattr(_SCOPE, "lane", None)
    if scoped is not None:
        return scoped
    if _LANE_OVERRIDE is not None:
        return _LANE_OVERRIDE
    env = os.environ.get("GP_SOLVER_LANE")
    if env is None or not env.strip():
        return "exact"
    return _validate_lane(env, "GP_SOLVER_LANE")


def set_solver_lane(lane):
    """Process-wide lane setter (the programmatic twin of
    ``GP_SOLVER_LANE``); ``None`` clears the override.  Returns the
    previous override."""
    global _LANE_OVERRIDE
    previous = _LANE_OVERRIDE
    _LANE_OVERRIDE = None if lane is None else _validate_lane(lane, "set_solver_lane")
    return previous


@contextlib.contextmanager
def solver_lane_scope(lane):
    """Pin the lane for this thread inside the block; ``None`` is a no-op."""
    if lane is None:
        yield
        return
    lane = _validate_lane(lane, "solver_lane_scope")
    prev = getattr(_SCOPE, "lane", None)
    _SCOPE.lane = lane
    try:
        yield
    finally:
        _SCOPE.lane = prev


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def auto_threshold() -> int:
    """Expert size at which ``auto`` switches to ``iterative``
    (``GP_SOLVER_AUTO_THRESHOLD``, default 1024)."""
    return _env_int("GP_SOLVER_AUTO_THRESHOLD", 1024)


def resolve_solver(
    expert_size: int,
    lane: Optional[str] = None,
    *,
    num_experts: Optional[int] = None,
    n_features: Optional[int] = None,
    itemsize: Optional[int] = None,
) -> str:
    """``exact``, ``iterative`` or ``matfree`` for experts of
    ``expert_size`` rows under ``lane`` (default: the active lane).

    ``auto`` is memory-budget-aware, as in the JAX package: below the
    size threshold ``exact``; at or above it the materialized iterative
    program is priced (``memplan.fit_dispatch_bytes`` at the iterative
    rung, with the ``num_experts`` / ``n_features`` / ``itemsize`` hints,
    1 / 1 / 4 when a caller knows only ``s``) against the planner's
    budget, and a predicted overshoot resolves ``matfree`` before any
    dispatch.  With no budget (planning off, or no CUDA context) the
    threshold alone decides."""
    lane = active_solver_lane() if lane is None else _validate_lane(lane, "resolve_solver")
    if lane != "auto":
        return lane
    s = int(expert_size)
    if s < auto_threshold():
        return "exact"
    from spark_gp_tpu_torch.resilience import memplan  # memplan imports this module

    budget = memplan.memory_budget_bytes() if memplan.enabled() else None
    if budget is None:
        return "iterative"
    raw = memplan.fit_dispatch_bytes(
        int(num_experts) if num_experts else 1, s,
        int(n_features) if n_features else 1, int(itemsize) if itemsize else 4,
        "iterative",
    )
    return "matfree" if memplan.predicted_bytes(raw) > budget else "iterative"


def resolve_for(data) -> str:
    """:func:`resolve_solver` for an expert stack, with its shape hints."""
    e, s, p = (int(d) for d in data.x.shape)
    return resolve_solver(s, num_experts=e, n_features=p, itemsize=data.x.element_size())


class SolverConfig(NamedTuple):
    """The iterative lane's knobs for one expert size."""

    iters: int
    probes: int
    rank: int
    tol: float
    seed: int


def solver_config(expert_size: int) -> SolverConfig:
    """The knobs for experts of ``expert_size`` rows, from the
    ``GP_SOLVER_*`` variables with the JAX package's defaults."""
    s = int(expert_size)
    iters = _env_int("GP_SOLVER_MAX_ITERS", 0) or min(s, 64)
    rank = _env_int("GP_SOLVER_PRECOND_RANK", 0) or min(s, 64)
    raw = os.environ.get("GP_SOLVER_CG_TOL", "").strip()
    try:
        tol = float(raw) if raw else 1e-5
    except ValueError:
        tol = 1e-5
    return SolverConfig(
        iters=min(iters, s),
        probes=_env_int("GP_SOLVER_PROBES", 8),
        rank=min(rank, s),
        tol=tol,
        seed=_env_int("GP_SOLVER_SEED", 0),
    )


# --------------------------------------------------------------------------
# partial pivoted Cholesky + Woodbury preconditioner
# --------------------------------------------------------------------------


def pivoted_cholesky_cols(diag0, col_fn, rank: int):
    """Greedy rank-``k`` pivoted partial Cholesky from a column oracle:
    ``diag0 [..., s]`` is the SPD stack's diagonal and ``col_fn(piv)``
    returns the ``[..., s]`` column at the per-batch pivot ``piv [...]``.
    Returns ``(L [..., s, k], delta [...])`` with ``L L^T ~= K`` on the k
    dominant pivots and ``delta`` the mean residual diagonal, floored at
    ``100 eps trace / s`` so ``P = L L^T + delta I`` is SPD.  No host sync:
    pivots stay on the device.

    A float32 stack is factored in float64 and the result rounded back:
    in float32 the residual diagonal's cancellation flips near-tied
    pivots, so ``P`` -- and with it the probes and the stochastic estimate
    -- leaves the float64 engine's.  At the protein-matfree config the
    float32-pivot NLL sat 2.9e-5 to 4.9e-2 (relative) from the float64
    one, the float64-pivot NLL 2.7e-7 to 1.5e-5
    (``spark_gp_tpu_torch/dev/slq_routes.py``, PERF.md §6)."""
    dtype = diag0.dtype
    work = torch.float64 if dtype == torch.float32 else dtype
    s = diag0.shape[-1]
    k = max(1, min(int(rank), s))
    batch = diag0.shape[:-1]
    d = diag0.to(work)
    trace = torch.sum(d, dim=-1)
    scale = torch.where(trace > 0, trace / s, torch.ones_like(trace))
    floor = 100.0 * torch.finfo(dtype).eps * scale
    lmat = d.new_zeros(batch + (s, k))
    iota = torch.arange(s, device=diag0.device)
    for j in range(k):
        piv = torch.argmax(d, dim=-1)
        dmax = torch.gather(d, -1, piv[..., None])[..., 0]
        ok = dmax > floor
        col = col_fn(piv).to(work)
        lrow = torch.gather(lmat, -2, piv[..., None, None].expand(batch + (1, k)))[..., 0, :]
        proj = torch.einsum("...sk,...k->...s", lmat, lrow)
        denom = torch.sqrt(torch.where(ok, dmax, 1.0))
        newcol = torch.where(ok[..., None], (col - proj) / denom[..., None], 0.0)
        lmat[..., :, j] = newcol
        d = torch.clamp_min(d - newcol * newcol, 0.0)
        # exclude the chosen pivot from later rounds
        d = torch.where(iota == piv[..., None], -torch.inf, d)
    resid = torch.where(d > 0, d, 0.0)
    delta = torch.maximum(torch.sum(resid, dim=-1) / max(s - k, 1), floor)
    return lmat.to(dtype), delta.to(dtype)


def _gather_col(kmat):
    """The column oracle of a materialized ``[..., s, s]`` stack."""
    s = kmat.shape[-1]

    def col_fn(piv):
        idx = piv[..., None, None].expand(piv.shape + (s, 1))
        return torch.gather(kmat, -1, idx)[..., 0]

    return col_fn


def pivoted_cholesky(kmat, rank: int):
    """:func:`pivoted_cholesky_cols` of a materialized ``[..., s, s]`` SPD
    stack (pass a detached view: the preconditioner is numerics, never
    part of the autograd graph)."""
    return pivoted_cholesky_cols(torch.diagonal(kmat, dim1=-2, dim2=-1), _gather_col(kmat), rank)


def woodbury_factor(lmat, delta):
    """Cholesky of ``C = delta I_k + L^T L`` (``[..., k, k]``); NaN when it
    fails."""
    k = lmat.shape[-1]
    eye = torch.eye(k, dtype=lmat.dtype, device=lmat.device)
    return cholesky(delta[..., None, None] * eye + lmat.mT @ lmat)


def woodbury_apply(lmat, delta, cfac, v):
    """``P^-1 v`` for ``P = L L^T + delta I`` by the Woodbury identity;
    ``v`` is ``[..., s, n]``."""
    inner = chol_solve(cfac, lmat.mT @ v)
    return (v - lmat @ inner) / delta[..., None, None]


def woodbury_logdet(lmat, delta, cfac):
    """``log|P| = (s - k) log delta + log|delta I + L^T L|``, exactly."""
    s, k = lmat.shape[-2], lmat.shape[-1]
    logdet_c = 2.0 * torch.sum(torch.log(torch.diagonal(cfac, dim1=-2, dim2=-1)), dim=-1)
    return (s - k) * torch.log(delta) + logdet_c


# --------------------------------------------------------------------------
# batched multi-RHS preconditioned conjugate gradients
# --------------------------------------------------------------------------


class PcgResult(NamedTuple):
    x: torch.Tensor          # [..., m, n] solutions
    alphas: torch.Tensor     # [t, ..., n] CG step sizes (1.0 past convergence)
    betas: torch.Tensor      # [t, ..., n] CG conjugation coeffs (0.0 past conv.)
    rel_resid: torch.Tensor  # [..., n] final relative residual norms
    iters_used: torch.Tensor  # [..., n] live iterations per RHS


def batched_pcg(matvec, rhs, precond=None, iters: int = 32, tol: float = 1e-5) -> PcgResult:
    """Preconditioned CG over a batched multi-RHS stack ``[..., m, n]``.

    A fixed trip count of ``iters`` steps, each one ``matvec`` of the whole
    block; a column freezes (its state stops updating) once its relative
    residual is under ``tol``.  The per-step ``(alpha, beta)`` records are
    the Lanczos tridiagonal of the preconditioned operator, for
    :func:`slq_logdet_from_coeffs`.  Nothing in the loop reads a value on
    the host."""
    tiny = torch.finfo(rhs.dtype).tiny
    apply_p = precond if precond is not None else (lambda v: v)
    x = torch.zeros_like(rhs)
    r = rhs
    z = apply_p(r)
    p = z
    rz = torch.sum(r * z, dim=-2)
    rr0 = torch.sum(r * r, dim=-2)
    thresh = (tol * tol) * torch.clamp_min(rr0, tiny)
    alphas, betas, lives = [], [], []
    for _ in range(int(iters)):
        live = torch.sum(r * r, dim=-2) > thresh
        ap = matvec(p)
        pap = torch.sum(p * ap, dim=-2)
        ok = live & (pap > tiny)
        alpha = torch.where(ok, rz / torch.where(ok, pap, 1.0), 0.0)
        x2 = x + alpha[..., None, :] * p
        r2 = r - alpha[..., None, :] * ap
        z2 = apply_p(r2)
        rz2 = torch.sum(r2 * z2, dim=-2)
        beta = torch.where(ok, rz2 / torch.where(ok, rz, 1.0), 0.0)
        p2 = z2 + beta[..., None, :] * p
        # frozen columns carry their state unchanged
        keep = ok[..., None, :]
        x = torch.where(keep, x2, x)
        r = torch.where(keep, r2, r)
        z = torch.where(keep, z2, z)
        p = torch.where(keep, p2, p)
        rz = torch.where(ok, rz2, rz)
        live_next = ok & (torch.sum(r * r, dim=-2) > thresh)
        # identity-pad frozen steps so T decouples into [live block] + I
        alphas.append(torch.where(ok, alpha, 1.0))
        betas.append(torch.where(ok & live_next, beta, 0.0))
        lives.append(ok)
    rel = torch.sqrt(torch.sum(r * r, dim=-2) / torch.clamp_min(rr0, tiny))
    return PcgResult(
        x=x,
        alphas=torch.stack(alphas),
        betas=torch.stack(betas),
        rel_resid=rel,
        iters_used=torch.stack(lives).to(rhs.dtype).sum(dim=0),
    )


def slq_logdet_from_coeffs(alphas, betas, weights):
    """Stochastic Lanczos quadrature from the PCG coefficients.

    ``alphas`` / ``betas`` are ``[t, ..., n]`` per-probe records; the
    Lanczos tridiagonal has ``T_jj = 1/alpha_j + beta_{j-1}/alpha_{j-1}``
    and ``T_{j,j+1} = sqrt(beta_j)/alpha_j``.  With probes ``z ~ N(0, P)``
    and ``weights = z^T P^-1 z``, ``mean_i weights_i e1^T log(T_i) e1``
    estimates ``logdet(K) - logdet(P)`` (Gardner et al. 2018); the
    quadrature of every probe's ``T`` is one call of
    ``ops/slq_quadrature.py``: the hand-written kernel on the card, which
    a captured step can hold, one batched ``eigh`` on the CPU, as in the
    JAX package."""
    from spark_gp_tpu_torch.ops.slq_quadrature import lanczos_tridiagonal, slq_quadrature

    per_probe = slq_quadrature(*lanczos_tridiagonal(alphas, betas))
    return torch.sum(weights * per_probe, dim=-1) / per_probe.shape[-1]


def draw_probes(cfg: SolverConfig, batch, rank: int, s: int, dtype, device):
    """The Gaussian draws behind the probes, ``g1 [*batch, rank, r]`` and
    ``g2 [*batch, s, r]``, from a generator on ``device`` seeded with
    ``cfg.seed`` at every call, so each evaluation sees the same probes.
    (The JAX package draws them with ``jax.random``; the tests inject its
    draws here.)"""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed))
    shape = tuple(batch)
    g1 = torch.randn(shape + (rank, cfg.probes), generator=gen, dtype=dtype, device=device)
    g2 = torch.randn(shape + (s, cfg.probes), generator=gen, dtype=dtype, device=device)
    return g1, g2


class ProbeSet:
    """A fit's probe draws, drawn once each and kept: the device optimizer's
    objectives hold one and evaluate under :func:`probe_scope`, so the draws
    happen at the fit's first (eager) evaluation, before any capture, and
    every later evaluation -- each replay of the captured step -- reads the
    same tensors.  The draws are :func:`draw_probes`' and
    :func:`draw_rademacher`'s at the same arguments, so the numbers are the
    per-call draws'.  ``experts`` (the stack's E) makes an ``[R * E, ...]``
    batch of R restart lanes share one ``[E, ...]`` draw, repeated, as the
    JAX package's vmapped lanes see the same probes."""

    def __init__(self, experts: Optional[int] = None) -> None:
        self.experts = experts
        self._draws: dict = {}

    def _lanes(self, lead: int) -> int:
        e = self.experts
        return lead // e if e and lead > e and lead % e == 0 else 1

    def _get(self, key, draw):
        got = self._draws.get(key)
        if got is None:
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a solver probe was drawn while a CUDA graph captures: the "
                    "fit's first evaluation must run before the capture")
            got = draw()
            self._draws[key] = got
        return got

    def gaussian(self, cfg: SolverConfig, batch, rank: int, s: int, dtype, device):
        batch = tuple(int(b) for b in batch)
        lanes = self._lanes(batch[0]) if batch else 1
        key = ("gaussian", int(cfg.seed), int(cfg.probes), batch, int(rank), int(s), dtype,
               str(device))

        def draw():
            one = (batch[0] // lanes,) + batch[1:] if batch else batch
            g1, g2 = draw_probes(cfg, one, rank, s, dtype, device)
            if lanes > 1:
                g1, g2 = (g.repeat((lanes,) + (1,) * (g.dim() - 1)) for g in (g1, g2))
            return g1, g2

        return self._get(key, draw)

    def rademacher(self, cfg: SolverConfig, shape, dtype, device):
        shape = tuple(int(d) for d in shape)
        lanes = self._lanes(shape[0])
        key = ("rademacher", int(cfg.seed), shape, dtype, str(device))

        def draw():
            z = draw_rademacher(cfg, (shape[0] // lanes,) + shape[1:], dtype, device)
            return z.repeat((lanes,) + (1,) * (z.dim() - 1)) if lanes > 1 else z

        return self._get(key, draw)


_PROBES = threading.local()


@contextlib.contextmanager
def probe_scope(probes: Optional[ProbeSet]):
    """Evaluate with ``probes`` (a :class:`ProbeSet`) as this thread's
    probe source inside the block; ``None`` is a no-op (per-call draws)."""
    prev = getattr(_PROBES, "current", None)
    _PROBES.current = probes if probes is not None else prev
    try:
        yield
    finally:
        _PROBES.current = prev


def _gaussian_probes(cfg: SolverConfig, batch, rank: int, s: int, dtype, device):
    """The engine's Gaussian draws: the scoped fit's :class:`ProbeSet`, else
    one :func:`draw_probes` call."""
    probes = getattr(_PROBES, "current", None)
    if probes is not None:
        return probes.gaussian(cfg, batch, rank, s, dtype, device)
    return draw_probes(cfg, batch, rank, s, dtype, device)


def _rademacher_probes(cfg: SolverConfig, shape, dtype, device):
    """The factored log-det's Rademacher draws: the scoped fit's
    :class:`ProbeSet`, else one :func:`draw_rademacher` call."""
    probes = getattr(_PROBES, "current", None)
    if probes is not None:
        return probes.rademacher(cfg, shape, dtype, device)
    return draw_rademacher(cfg, shape, dtype, device)


# --------------------------------------------------------------------------
# the marginal-NLL engine
# --------------------------------------------------------------------------


def _solve_pass(matvec_sg, diag_sg, col_fn_sg, y, cfg: SolverConfig):
    """The forward-only part of the engine: the preconditioner, the probes
    ``z = L g1 + sqrt(delta) g2 ~ N(0, P)``, one PCG against ``[y, Z]``
    and the log-det value ``logdet(P) + SLQ``."""
    s = y.shape[-1]
    lmat, delta = pivoted_cholesky_cols(diag_sg, col_fn_sg, cfg.rank)
    cfac = woodbury_factor(lmat, delta)
    g1, g2 = _gaussian_probes(cfg, y.shape[:-1], lmat.shape[-1], s, y.dtype, y.device)
    z = lmat @ g1 + torch.sqrt(delta)[..., None, None] * g2
    res = batched_pcg(
        matvec_sg,
        torch.cat([y[..., None], z], dim=-1),
        precond=lambda v: woodbury_apply(lmat, delta, cfac, v),
        iters=cfg.iters,
        tol=cfg.tol,
    )
    vtil = woodbury_apply(lmat, delta, cfac, z)  # P^-1 Z
    weights = torch.sum(z * vtil, dim=-2)         # z^T P^-1 z  [E, r]
    logdet_val = woodbury_logdet(lmat, delta, cfac) + slq_logdet_from_coeffs(
        res.alphas[..., 1:], res.betas[..., 1:], weights
    )
    return res, vtil, logdet_val


def inv_quad_logdet_matfree(matvec, matvec_sg, diag_sg, col_fn_sg, y,
                            config: Optional[SolverConfig] = None):
    """``(y^T K^-1 y [E], logdet K [E])`` with the operator injected: the
    matfree lane's marginal-NLL engine.

    ``matvec(v)`` is the differentiable ``K @ v`` on ``[E, s, n]`` blocks;
    ``matvec_sg`` its detached twin the CG loop runs on; ``diag_sg [E, s]``
    and ``col_fn_sg(piv)`` the detached diagonal and pivot-column oracle
    of the preconditioner.  The value is the CG/SLQ estimate; the gradient
    flows only through the two ``matvec`` calls (module doc)."""
    cfg = config or solver_config(y.shape[-1])
    with torch.no_grad():
        res, vtil, logdet_val = _solve_pass(matvec_sg, diag_sg.detach(), col_fn_sg,
                                            y.detach(), cfg)
    alpha = res.x[..., 0]   # K^-1 y   [E, s]
    u = res.x[..., 1:]      # K^-1 Z   [E, s, r]
    ka = matvec(alpha[..., None])[..., 0]
    quad = 2.0 * torch.sum(alpha * y, dim=-1) - torch.sum(alpha * ka, dim=-1)
    surr = torch.sum(vtil * matvec(u), dim=(-2, -1)) / cfg.probes
    logdet = (logdet_val - surr).detach() + surr
    return quad, logdet


def inv_quad_logdet(kmat, y, config: Optional[SolverConfig] = None):
    """:func:`inv_quad_logdet_matfree` on a materialized ``[E, s, s]`` SPD
    stack (the iterative lane): the same engine, with ``torch`` matmuls
    for the products.  NaN or inf in ``kmat`` gives NaN outputs."""
    km = kmat.detach()
    return inv_quad_logdet_matfree(
        lambda v: kmat @ v, lambda v: km @ v,
        torch.diagonal(km, dim1=-2, dim2=-1), _gather_col(km), y, config,
    )


# --------------------------------------------------------------------------
# SPD solve / logdet of materialized operators (the Laplace B systems)
# --------------------------------------------------------------------------


def _cg_only(matvec, b, iters, tol, precond=None):
    return batched_pcg(matvec, b, precond, iters, tol).x


def _spd_preconditioner(am, cfg: SolverConfig):
    """``(P^-1 applier, lmat, delta, cfac)`` for a detached SPD stack: the
    rank-k pivoted-Cholesky + Woodbury preconditioner of the marginal
    engine.  The Laplace systems ``B = I + sqrtW K sqrtW`` have eigenvalues
    >= 1 but a conditioning of ``1 + lambda_max(K W)``, in the thousands on
    dense grams, where unpreconditioned float32 CG loses conjugacy."""
    lmat, delta = pivoted_cholesky(am, cfg.rank)
    cfac = woodbury_factor(lmat, delta)
    return (lambda v: woodbury_apply(lmat, delta, cfac, v)), lmat, delta, cfac


def build_spd_preconditioner(amat, config: Optional[SolverConfig] = None):
    """The preconditioner triple ``(lmat, delta, cfac)`` of an SPD stack,
    for callers that run several :func:`spd_solve` / :func:`spd_logdet`
    against one stack (the classifier's Newton step, its full inverse and
    its log-det) and so build it once.  Built from the detached stack: the
    preconditioner is numerics, never part of the autograd graph."""
    cfg = config or solver_config(amat.shape[-1])
    _, lmat, delta, cfac = _spd_preconditioner(amat.detach(), cfg)
    return lmat, delta, cfac


def _precond_applier(amat, cfg: SolverConfig, precond):
    if precond is None:
        return _spd_preconditioner(amat.detach(), cfg)
    lmat, delta, cfac = precond
    return (lambda v: woodbury_apply(lmat, delta, cfac, v)), lmat, delta, cfac


class _SpdSolve(torch.autograd.Function):
    """``x = A^-1 b`` by a solver; the backward solves the symmetric system
    again (``b_bar = A^-1 x_bar``, ``A_bar = -b_bar x^T``), which is the
    exact implicit gradient at convergence."""

    @staticmethod
    def forward(ctx, amat, b, solve):
        x = solve(amat.detach(), b.detach())
        ctx.solve = solve
        ctx.save_for_backward(amat, x)
        return x

    @staticmethod
    def backward(ctx, g_x):
        amat, x = ctx.saved_tensors
        g_b = ctx.solve(amat.detach(), g_x)
        g_a = -g_b @ x.mT if ctx.needs_input_grad[0] else None
        return g_a, g_b, None


def spd_solve(amat, b, config: Optional[SolverConfig] = None, precond=None):
    """``A^-1 b`` for a materialized SPD stack ``A [..., s, s]`` and ``b``
    of ``[..., s]`` or ``[..., s, n]``, by pivoted-Cholesky preconditioned
    CG; differentiable in ``A`` and ``b`` by solving again in the backward.
    ``precond`` is an optional prebuilt :func:`build_spd_preconditioner`
    triple."""
    cfg = config or solver_config(amat.shape[-1])
    vector = b.ndim == amat.ndim - 1
    b2 = b[..., None] if vector else b
    apply_p = _precond_applier(amat, cfg, precond)[0]

    def solve(a, rhs):
        return _cg_only(lambda v: a @ v, rhs, cfg.iters, cfg.tol, precond=apply_p)

    x = _SpdSolve.apply(amat, b2, solve)
    return x[..., 0] if vector else x


def spd_logdet(amat, config: Optional[SolverConfig] = None, precond=None):
    """``logdet(A) [...]`` for a materialized SPD stack: the exact
    ``logdet(P)`` of the preconditioner plus preconditioned SLQ of the
    remainder, on probes ``z ~ N(0, P)`` drawn from ``seed + 1`` (the JAX
    package's draw for this function), with the Hutchinson surrogate
    ``mean_i (P^-1 z_i)^T A (A^-1 z_i)`` carrying the gradient.
    ``precond`` is an optional prebuilt :func:`build_spd_preconditioner`
    triple."""
    s = amat.shape[-1]
    cfg = config or solver_config(s)
    am = amat.detach()
    apply_p, lmat, delta, cfac = _precond_applier(am, cfg, precond)
    g1, g2 = _gaussian_probes(cfg._replace(seed=cfg.seed + 1), am.shape[:-2],
                              lmat.shape[-1], s, am.dtype, am.device)
    z = lmat @ g1 + torch.sqrt(delta)[..., None, None] * g2
    with torch.no_grad():
        res = batched_pcg(lambda v: am @ v, z, apply_p, cfg.iters, cfg.tol)
        vtil = apply_p(z)                       # P^-1 z
        weights = torch.sum(z * vtil, dim=-2)   # z^T P^-1 z
        val = woodbury_logdet(lmat, delta, cfac) + slq_logdet_from_coeffs(
            res.alphas, res.betas, weights
        )
    surr = torch.sum(vtil * (amat @ res.x), dim=(-2, -1)) / cfg.probes
    return (val - surr).detach() + surr


# --------------------------------------------------------------------------
# factored operators: B' = I + S^T K_blk S (the multiclass Laplace system)
# --------------------------------------------------------------------------


def _factored_matvec(kmat, smat, v):
    """``(I + S^T K_blk S) v`` on ``[E, s, C]`` latent vectors, with
    ``S [E, s, C, C]`` the per-row factor of the softmax Hessian
    (``W = S S^T``) and ``K_blk = I_C (x) K`` applied class by class:
    the ``[sC, sC]`` block operator is never built."""
    sv = torch.einsum("escd,esd->esc", smat, v)
    ksv = torch.einsum("est,etc->esc", kmat, sv)
    return v + torch.einsum("esdc,esd->esc", smat, ksv)


def _factored_matvec_probes(kmat, smat, v):
    """:func:`_factored_matvec` on a probe-batched ``v [E, n, s, C]``: the
    probe axis rides the products, so the gram stack is read once an
    application."""
    sv = torch.einsum("escd,ensd->ensc", smat, v)
    ksv = torch.einsum("est,entc->ensc", kmat, sv)
    return v + torch.einsum("esdc,ensd->ensc", smat, ksv)


class _FactoredSolve(torch.autograd.Function):
    """``x = B'^-1 b`` by CG; the backward solves the symmetric system
    again (``b_bar = B'^-1 x_bar``) and takes ``kmat`` and ``smat``'s
    cotangents from the VJP of the matvec at ``x`` against ``-b_bar``:
    the exact implicit gradient at convergence (the JAX package's
    symmetric ``custom_linear_solve``)."""

    @staticmethod
    def forward(ctx, kmat, smat, b, solve):
        km, sm = kmat.detach(), smat.detach()
        x = solve(km, sm, b.detach())
        ctx.solve = solve
        ctx.save_for_backward(km, sm, x)
        return x

    @staticmethod
    def backward(ctx, g_x):
        km, sm, x = ctx.saved_tensors
        g_b = ctx.solve(km, sm, g_x)
        need_k, need_s = ctx.needs_input_grad[:2]
        g_k = g_s = None
        if need_k or need_s:
            with torch.enable_grad():
                k = km.detach().requires_grad_(need_k)
                s_ = sm.detach().requires_grad_(need_s)
                # <B' x, -b_bar>: a scalar, so no cotangent is handed in
                inner = -torch.sum(_factored_matvec(k, s_, x) * g_b)
                wrt = [t for t, need in ((k, need_k), (s_, need_s)) if need]
                grads = iter(torch.autograd.grad(inner, wrt))
            g_k = next(grads) if need_k else None
            g_s = next(grads) if need_s else None
        return g_k, g_s, g_b, None


def factored_solve(kmat, smat, b, config: Optional[SolverConfig] = None):
    """``(I + S^T K_blk S)^-1 b`` for ``b [E, s, C]`` by unpreconditioned
    CG on the factored operator; differentiable in ``kmat``, ``smat`` and
    ``b`` (:class:`_FactoredSolve`)."""
    e, s, c = b.shape
    cfg = config or solver_config(s)

    def solve(km, sm, rhs):
        def mv(vflat):
            v = vflat[..., 0].reshape(e, s, c)
            return _factored_matvec(km, sm, v).reshape(e, s * c)[..., None]

        x = _cg_only(mv, rhs.reshape(e, s * c)[..., None], cfg.iters, cfg.tol)
        return x[..., 0].reshape(e, s, c)

    return _FactoredSolve.apply(kmat, smat, b, solve)


def draw_rademacher(cfg: SolverConfig, shape, dtype, device):
    """Rademacher (+-1) probes of ``shape`` from a generator on ``device``
    seeded with ``cfg.seed`` at every call, as :func:`draw_probes` draws
    its Gaussians.  (The tests inject the JAX package's draws here.)"""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed))
    bits = torch.randint(0, 2, tuple(shape), generator=gen, device=device)
    return (2 * bits - 1).to(dtype)


def factored_logdet(kmat, smat, config: Optional[SolverConfig] = None):
    """``logdet(I + S^T K_blk S) [E]``, which by Sylvester equals
    ``logdet(I + K_blk W)``: SLQ on Rademacher probes (drawn from
    ``seed + 2``, the JAX package's draw for this function) through the
    factored operator, with the Hutchinson surrogate through the
    differentiable matvec carrying the gradient to ``kmat`` and
    ``smat``."""
    e, s = kmat.shape[0], kmat.shape[-1]
    c = smat.shape[-1]
    cfg = config or solver_config(s)
    km, sm = kmat.detach(), smat.detach()
    z = _rademacher_probes(cfg._replace(seed=cfg.seed + 2), (e, s * c, cfg.probes),
                           km.dtype, km.device)

    def to_probes(vs):  # [E, sC, n] -> [E, n, s, C]
        return vs.movedim(-1, 1).reshape(e, cfg.probes, s, c)

    with torch.no_grad():
        res = batched_pcg(
            lambda vs: _factored_matvec_probes(km, sm, to_probes(vs))
            .reshape(e, cfg.probes, s * c).movedim(1, -1),
            z, None, cfg.iters, cfg.tol,
        )
        val = slq_logdet_from_coeffs(res.alphas, res.betas, torch.sum(z * z, dim=-2))
    bu = _factored_matvec_probes(kmat, smat, to_probes(res.x)).reshape(e, cfg.probes, s * c)
    surr = torch.einsum("enm,enm->e", z.movedim(-1, 1), bu) / cfg.probes
    return (val - surr).detach() + surr


# --------------------------------------------------------------------------
# diagnostics: the post-fit convergence probe
# --------------------------------------------------------------------------


def solver_report(kmat, y, config: Optional[SolverConfig] = None, *,
                  matvec=None, diag=None, col_fn=None) -> dict:
    """Convergence diagnostics of the iterative lane at the fitted
    hyperparameters: one forward pass of the engine over the stack,
    reporting the knobs, the achieved residuals of the ``y`` column and
    value finiteness.  Operator mode (``kmat=None`` with the detached
    ``matvec`` / ``diag`` / ``col_fn``) reruns the matfree program itself,
    streamed products and no gram."""
    if matvec is None:
        if kmat is None:
            raise ValueError(
                "solver_report: operator mode (kmat=None) requires the "
                "matvec/diag/col_fn closures"
            )
        km = kmat.detach()
        return solver_report(None, y, config, matvec=lambda v: km @ v,
                             diag=torch.diagonal(km, dim1=-2, dim2=-1),
                             col_fn=_gather_col(km))
    cfg = config or solver_config(y.shape[-1])
    with torch.no_grad():
        res, _, logdet = _solve_pass(matvec, diag, col_fn, y, cfg)
        quad = torch.sum(res.x[..., 0] * y, dim=-1)
        # the pass's one host read: residuals, live iterations, finiteness
        flat = torch.cat([res.rel_resid[..., 0].reshape(-1), res.iters_used[..., 0].reshape(-1),
                          torch.isfinite(quad).all().to(y.dtype)[None],
                          torch.isfinite(logdet).all().to(y.dtype)[None]])
    host = flat.to(torch.float64).cpu().numpy()
    k = res.rel_resid[..., 0].numel()
    rel, iters = host[:k], host[k:2 * k]
    return {
        "cg_iters": float(iters.max(initial=0.0)),
        "cg_iters_mean": float(iters.mean()) if iters.size else 0.0,
        "residual": float(rel.max(initial=0.0)),
        "precond_rank": float(cfg.rank),
        "probes": float(cfg.probes),
        "max_iters": float(cfg.iters),
        "quad_finite": bool(host[2 * k]),
        "logdet_finite": bool(host[2 * k + 1]),
    }
