"""On-device box-constrained L-BFGS-B, the port of the JAX package's
``optimize/lbfgs_device.py``.

The JAX package runs the whole hyperparameter optimization as one
``lax.while_loop``: objective, gradient, line search and history updates
in one XLA program, so a fit costs one dispatch instead of one host
round trip per objective evaluation.  The port keeps its algorithm --
true box L-BFGS-B (Byrd, Lu, Nocedal and Zhu 1995): the generalized
Cauchy point of the quadratic model along the projected-gradient path,
a dense subspace Newton step over the free variables backtracked into
the box, and a weak-Wolfe bracketing line search over the clipped path
-- and recasts the loop as a **state machine whose unit is one objective
evaluation**, because a CUDA graph replays a fixed sequence of kernels
and neither the iteration loop nor the line search (up to ``max_ls``
trials) has a fixed count:

* :func:`lbfgs_step` evaluates the objective once, at the state's trial
  point, and advances the line search; when the search ends it accepts
  the iterate, updates the curvature history, tests convergence and
  prepares the next iteration's direction (Cauchy point, subspace solve)
  and first trial.  Every state tensor has a fixed shape, and a lane
  that is ``frozen`` (``done``, or at its segment's iteration limit)
  keeps its state: every update is a ``torch.where`` on the mask, as the
  JAX body's ``where(state.done, old, new)``.
* :class:`DeviceLoop` runs the step: on a CUDA stack it captures it once
  into a ``torch.cuda.CUDAGraph`` over static state buffers and replays
  it :data:`REPLAY_BATCH` times between host reads of the frozen flags,
  so a fit makes one host sync per batch instead of one per evaluation;
  on the CPU it runs the same step eagerly, so the CPU tests run the
  code the graph captures.  Evaluations the algorithm used count in
  ``n_fev``; replays after a lane froze count apart as masked
  evaluations.
* every tensor carries a leading ``[R]`` dimension of lanes (R = 1 for
  one start): :func:`lbfgs_minimize_device_multistart` runs R starting
  points in lockstep, the objective evaluates all lanes in one pass (one
  K1 launch over the R lanes' stacks), a finished lane stays frozen with
  its own diagnostics, and the winner is chosen on the device.

An objective with an inner loop -- the Laplace families' Newton loop
for the latent modes -- is a *latent objective* (``trial`` /
``evaluate`` / ``reset``, :func:`is_latent`), the JAX package's
``value_and_grad_aux`` with its ``aux`` carry:

* ``state["aux"]`` (``[R, E, s]`` or ``[R, E, s, C]``) holds the modes at
  the last accepted iterate; every trial of the line search starts its
  Newton loop from them, the kept trial's modes ride in ``aux_new``
  under the same mask as ``f_new`` / ``g_new``, and become ``aux`` when
  the iteration ends (JAX ``lbfgs_device.py`` ``aux_new`` / ``aux``);
* one step holds ``k`` unrolled Newton iterations (the objective's
  ``newton_k``), each masked per expert exactly as the host loop, then
  the converged-state gradient pass.  A trial whose Newton loop has not
  ended after ``k`` iterations carries its Newton state (``nt_f``,
  ``nt_old``, ``nt_new``, ``nt_step``) to the next step, and the line
  search holds, masked, until it ends; so any ``k`` gives the iterates of
  the uncapped JAX ``while_loop``.  The card's PyTorch (2.11) has no
  CUDA-graph conditional node, so the unrolled iterations and the pass
  run on every replay, masked to no-ops where they have nothing to do;
  ``newton_iterations`` and ``gradient_passes`` count, on the device,
  the ones that did work (the host loop's count), read at the loop's
  existing host reads.

Fixed-count loops (the Cauchy point's h segments, the history's m_hist
BFGS updates, the ``[h, h]`` solve) are unrolled.  The subspace solve is
LU with partial pivoting in plain tensor operations (h is the kernel's
hyperparameter count, 1 to ~100): no library call that reads its status
on the host sits inside the step.
"""

from __future__ import annotations

import math
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from spark_gp_tpu_torch.obs import cost as obs_cost

#: replays between two host reads of the lanes' frozen flags
REPLAY_BATCH = 8

#: the JAX package's ``_LbfgsState`` fields, in order (its checkpoint
#: payload's ``leaf_i`` layout); ``aux`` is the objectives' carry: the
#: latent modes of a latent objective, a zero scalar (not held on the
#: device) for the regression objectives
STATE_FIELDS = (
    "theta", "f", "grad", "aux", "s_hist", "y_hist", "hist_count",
    "hist_head", "n_iter", "n_fev", "done", "stalled",
)
#: a latent objective's Newton state of the trial in flight (an objective
#: with another inner loop names its own carry in ``carry_fields``, the
#: trial's latents always ``nt_f``: EP's site sweeps, ``models/ep.py``)
NEWTON_FIELDS = ("nt_f", "nt_old", "nt_new", "nt_step")


def carry_fields(vag) -> tuple:
    """The state fields of a latent objective's trial in flight."""
    return tuple(getattr(vag, "carry_fields", NEWTON_FIELDS))


class _LbfgsState(NamedTuple):
    """One lane's optimizer state between iterations (the JAX package's
    ``_LbfgsState``, numpy on the host): the checkpoint unit."""

    theta: np.ndarray
    f: np.ndarray
    grad: np.ndarray
    aux: np.ndarray
    s_hist: np.ndarray
    y_hist: np.ndarray
    hist_count: np.ndarray
    hist_head: np.ndarray
    n_iter: np.ndarray
    n_fev: np.ndarray
    done: np.ndarray
    stalled: np.ndarray


class LbfgsConfig(NamedTuple):
    """The problem's box and the algorithm's constants (the JAX
    defaults)."""

    lower: torch.Tensor
    upper: torch.Tensor
    tol: float = 1e-6
    m_hist: int = 10
    max_ls: int = 25
    armijo_c1: float = 1e-4


# --- log-domain reparameterization ------------------------------------------


def is_latent(vag) -> bool:
    """Whether ``vag`` is a latent objective (module doc): an object with
    ``trial(thetas, carry, run) -> (f [R], g [R, h], carry, finished [R],
    worked)``, ``evaluate(thetas, aux) -> (f, g, aux)`` (one whole
    evaluation, eagerly) and ``reset(aux) -> carry``."""
    return hasattr(vag, "trial")


class _LogLatent:
    """A latent objective in ``u = log(theta)`` coordinates."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.carry_fields = carry_fields(inner)

    def evaluate(self, u, aux):
        theta = torch.exp(u)
        value, grad, aux = self.inner.evaluate(theta, aux)
        return value, grad * theta, aux

    def trial(self, u, carry, run):
        theta = torch.exp(u)
        value, grad, carry, finished, worked = self.inner.trial(theta, carry, run)
        return value, grad * theta, carry, finished, worked

    def reset(self, aux):
        return self.inner.reset(aux)


def log_transform_vag(vag):
    """Chain-rule wrap of a lanes objective ``theta [R, h] -> (f [R],
    g [R, h])`` (or of a latent objective) for ``u = log(theta)``
    coordinates."""
    if is_latent(vag):
        return _LogLatent(vag)

    def vag_u(u):
        theta = torch.exp(u)
        value, grad = vag(theta)
        return value, grad * theta

    return vag_u


def log_transform_bounds(lower, upper):
    """Box bounds mapped through log (0 lower -> -inf, inf upper -> inf)."""
    tiny = torch.full_like(lower, 1e-300)
    lower_u = torch.where(lower > 0, torch.log(torch.maximum(lower, tiny)),
                          torch.full_like(lower, -math.inf))
    upper_u = torch.where(torch.isposinf(upper), torch.full_like(upper, math.inf),
                          torch.log(torch.maximum(upper, tiny)))
    return lower_u, upper_u


def log_reparam(vag, theta0, lower, upper):
    """``(vag_u, u0, lower_u, upper_u, from_u)``: the objective, start and
    box in ``u = log(theta)``; the caller guarantees theta0 > 0 and
    lower >= 0."""
    lower_u, upper_u = log_transform_bounds(lower, upper)
    return log_transform_vag(vag), torch.log(theta0), lower_u, upper_u, torch.exp


# --- the quasi-Newton model ---------------------------------------------------


def _dot(a, b):
    return (a * b).sum(-1)


def _gather_slot(hist, slot):
    """``hist[r, slot[r]]`` of a ``[R, m, h]`` history."""
    idx = slot.long()[:, None, None].expand(hist.shape[0], 1, hist.shape[2])
    return torch.gather(hist, 1, idx)[:, 0]


def _dense_b_from_history(s_hist, y_hist, count, head, m_hist: int):
    """The L-BFGS Hessian approximation as a dense ``[R, h, h]`` matrix:
    ``theta I`` (``theta = y.y / s.y`` of the newest pair) updated by the
    stored curvature pairs, oldest to newest, as dense BFGS updates;
    unfilled slots are skipped by the mask."""
    h = s_hist.shape[2]
    newest = (head - 1) % m_hist
    s_n, y_n = _gather_slot(s_hist, newest), _gather_slot(y_hist, newest)
    sy_n = _dot(s_n, y_n)
    yy_n = _dot(y_n, y_n)
    theta = torch.where((count > 0) & (sy_n > 0), yy_n / torch.clamp_min(sy_n, 1e-30),
                        torch.ones_like(sy_n))
    b_mat = theta[:, None, None] * torch.eye(h, dtype=s_hist.dtype, device=s_hist.device)
    for i in range(m_hist):
        slot = (head - count + i) % m_hist
        valid = i < count
        s, y = _gather_slot(s_hist, slot), _gather_slot(y_hist, slot)
        sy = _dot(s, y)
        bs = (b_mat @ s[..., None])[..., 0]
        sbs = _dot(s, bs)
        b_new = (b_mat - bs[:, :, None] * bs[:, None, :] / torch.clamp_min(sbs, 1e-30)[:, None, None]
                 + y[:, :, None] * y[:, None, :] / torch.clamp_min(sy, 1e-30)[:, None, None])
        b_mat = torch.where(valid[:, None, None], b_new, b_mat)
    return b_mat


def _steps_to_bounds(origin, direction, lower, upper, fill: float):
    """Per-coordinate step along ``direction`` until each coordinate of
    ``origin`` hits its bound; ``fill`` where the direction is zero or
    the ratio is indeterminate."""
    pos = direction > 0.0
    neg = direction < 0.0
    one = torch.ones_like(direction)
    steps = torch.where(
        pos,
        (upper - origin) / torch.where(pos, direction, one),
        torch.where(neg, (lower - origin) / torch.where(neg, direction, one),
                    torch.full_like(direction, fill)),
    )
    return torch.where(torch.isnan(steps), torch.full_like(steps, fill), steps)


def _cauchy_point(x, g, lower, upper, b_mat):
    """Generalized Cauchy point of ``m(z) = g.z + z^T B z / 2`` along the
    projected steepest-descent path, segment by segment between the
    sorted bound breakpoints (Byrd et al. 1995).  Returns ``(z_c, fixed)``:
    the step to the Cauchy point and the variables that hit their bound
    before it."""
    r, h = x.shape
    dtype = x.dtype
    big = torch.finfo(dtype).max
    t_break = _steps_to_bounds(x, -g, lower, upper, math.inf)
    order = torch.argsort(t_break, dim=-1, stable=True)
    t_prev = x.new_zeros(r)
    z = torch.zeros_like(x)
    d = -g
    fixed = torch.zeros_like(x, dtype=torch.bool)
    done = torch.zeros(r, dtype=torch.bool, device=x.device)
    lower_b, upper_b = lower.expand_as(x), upper.expand_as(x)
    for j in range(h):
        idx = order[:, j:j + 1]
        t_j = torch.gather(t_break, 1, idx)[:, 0]
        bd = (b_mat @ d[..., None])[..., 0]
        f1 = _dot(g, d) + _dot(z, bd)
        f2 = torch.clamp_min(_dot(d, bd), 1e-30)
        dt_star = -f1 / f2
        seg_len = t_j - t_prev
        hit = ~done & ((f1 >= 0.0) | (dt_star <= seg_len))
        dt = torch.minimum(torch.clamp_min(dt_star, 0.0), torch.clamp_max(seg_len, big))
        z_min = z + dt[:, None] * d
        # otherwise advance to the breakpoint and pin the variable exactly
        # at its bound
        g_i = torch.gather(g, 1, idx)
        x_i = torch.gather(x, 1, idx)
        pin = torch.where(g_i < 0.0, torch.gather(upper_b, 1, idx) - x_i,
                          torch.gather(lower_b, 1, idx) - x_i)
        z_at_break = (z + seg_len[:, None] * d).scatter(1, idx, pin)
        advance = ~done & ~hit
        t_prev = torch.where(done | hit, t_prev, t_j)
        z = torch.where(hit[:, None], z_min, torch.where(advance[:, None], z_at_break, z))
        d = torch.where(advance[:, None], d.scatter(1, idx, torch.zeros_like(pin)), d)
        fixed = torch.where(advance[:, None],
                            fixed.scatter(1, idx, torch.ones_like(idx, dtype=torch.bool)), fixed)
        done = done | hit
    # the last, unbounded segment
    bd = (b_mat @ d[..., None])[..., 0]
    f1 = _dot(g, d) + _dot(z, bd)
    f2 = torch.clamp_min(_dot(d, bd), 1e-30)
    dt = torch.clamp_min(-f1 / f2, 0.0)
    z_c = torch.where(done[:, None], z, z + dt[:, None] * d)
    return z_c, fixed


def _solve_small(a, b):
    """``a^-1 b`` for ``[R, h, h]`` ``a`` and ``[R, h]`` ``b``: LU with
    partial pivoting (row swaps, the multipliers scaled by the pivot's
    reciprocal), then column-oriented back substitution, unrolled over
    h.  A singular
    ``a`` gives non-finite entries."""
    r, h = b.shape
    a = a.clone()
    b = b.clone()
    rows = torch.arange(h, device=a.device)
    for k in range(h):
        piv_row = k + torch.argmax(a[:, k:, k].abs(), dim=1)
        perm = torch.where(rows == k, piv_row[:, None],
                           torch.where(rows == piv_row[:, None], k, rows))
        a = torch.gather(a, 1, perm[:, :, None].expand(r, h, h))
        b = torch.gather(b, 1, perm)
        if k + 1 < h:
            mult = a[:, k + 1:, k] * (1.0 / a[:, k, k])[:, None]
            a[:, k + 1:, k + 1:] -= mult[:, :, None] * a[:, k:k + 1, k + 1:]
            b[:, k + 1:] -= mult * b[:, k:k + 1]
    for k in range(h - 1, -1, -1):
        b[:, k] = b[:, k] / a[:, k, k]
        if k:
            b[:, :k] -= b[:, k:k + 1] * a[:, :k, k]
    return b


def _lbfgsb_direction(x, g, lower, upper, s_hist, y_hist, count, head, m_hist: int):
    """The box L-BFGS-B proposal ``x_bar - x``: the generalized Cauchy
    point, then the quadratic model minimized over the free variables
    with the Cauchy active set held fixed, backtracked into the box.  In
    the interior it is the quasi-Newton step ``-B^-1 g``."""
    dtype = x.dtype
    b_mat = _dense_b_from_history(s_hist, y_hist, count, head, m_hist)
    z_c, fixed = _cauchy_point(x, g, lower, upper, b_mat)
    free_f = (~fixed).to(dtype)
    rhs = -(g + (b_mat @ z_c[..., None])[..., 0]) * free_f
    m_free = b_mat * free_f[:, :, None] * free_f[:, None, :] + torch.diag_embed(1.0 - free_f)
    d_f = _solve_small(m_free, rhs)
    d_f = torch.where(torch.isfinite(d_f).all(-1, keepdim=True), d_f, torch.zeros_like(d_f))
    x_c = x + z_c
    big = torch.finfo(dtype).max
    room = _steps_to_bounds(x_c, d_f, lower, upper, big)
    alpha = torch.clamp(torch.where(~fixed, room, torch.full_like(room, big)).amin(-1), 0.0, 1.0)
    return z_c + alpha[:, None] * d_f


# --- the state machine --------------------------------------------------------


def _proj(theta, cfg: LbfgsConfig):
    return torch.minimum(torch.maximum(theta, cfg.lower), cfg.upper)


def _proj_grad_norm(theta, grad, cfg: LbfgsConfig):
    """Inf-norm of the projected gradient: zero at a KKT point of the box."""
    if theta.shape[-1] == 0:
        return theta.new_zeros(theta.shape[0])
    return (_proj(theta - grad, cfg) - theta).abs().amax(-1)


def lbfgs_init_state(vag, theta0, cfg: LbfgsConfig, aux0=None) -> Dict[str, torch.Tensor]:
    """Evaluate the objective once at ``theta0 [R, h]`` (a latent
    objective from the modes ``aux0``) and build the carried state, the
    next iteration prepared (:func:`prepare`)."""
    with torch.no_grad():
        r, h = theta0.shape
        dtype, dev = theta0.dtype, theta0.device
        if is_latent(vag):
            f0, g0, aux = vag.evaluate(theta0, aux0)
        else:
            f0, g0 = vag(theta0)
        i32 = dict(dtype=torch.int32, device=dev)
        state = {
            "theta": theta0.clone(), "f": f0, "grad": g0,
            "s_hist": torch.zeros((r, cfg.m_hist, h), dtype=dtype, device=dev),
            "y_hist": torch.zeros((r, cfg.m_hist, h), dtype=dtype, device=dev),
            "hist_count": torch.zeros(r, **i32), "hist_head": torch.zeros(r, **i32),
            "n_iter": torch.zeros(r, **i32), "n_fev": torch.ones(r, **i32),
            "done": torch.zeros(r, dtype=torch.bool, device=dev),
            "stalled": torch.zeros(r, dtype=torch.bool, device=dev),
            "evaluations": torch.zeros(r, **i32),
        }
        if is_latent(vag):
            state.update(_latent_fields(vag, aux))
        state.update(prepare(state, cfg))
        return state


def _latent_fields(vag, aux) -> Dict[str, torch.Tensor]:
    """The state a latent objective adds: the modes, the Newton carry of
    the next trial, and the device counters of Newton iterations and
    gradient passes that did work and of the lanes' steps."""
    i32 = dict(dtype=torch.int32, device=aux.device)
    return {"aux": aux, **vag.reset(aux),
            "newton_iterations": torch.zeros((), **i32),
            "gradient_passes": torch.zeros((), **i32),
            "lane_steps": torch.zeros(aux.shape[0], **i32)}


def prepare(state, cfg: LbfgsConfig) -> Dict[str, torch.Tensor]:
    """The line search's carry at an iteration's start: the direction
    (steepest descent where the model's step is not a descent direction)
    and the first trial step ``min(1, 1/|d|_inf)`` without history, 1
    with it.  An iterate that is already box-stationary (``already_opt``)
    or done starts with its search accepted: its iteration then ends on
    the next step without an evaluation, as the JAX loop skips the
    search."""
    with torch.no_grad():
        theta, grad = state["theta"], state["grad"]
        dtype = theta.dtype
        direction = _lbfgsb_direction(
            theta, grad, cfg.lower, cfg.upper, state["s_hist"], state["y_hist"],
            state["hist_count"], state["hist_head"], cfg.m_hist,
        )
        descent = _dot(direction, grad) < 0
        direction = torch.where(descent[:, None], direction, -grad)
        already_opt = _proj_grad_norm(theta, grad, cfg) <= cfg.tol
        one = torch.ones_like(state["f"])
        if theta.shape[-1]:
            d_max = torch.clamp_min(direction.abs().amax(-1), 1e-30)
        else:
            d_max = one
        t_init = torch.where(state["hist_count"] == 0, torch.minimum(one, 1.0 / d_max), one)
        zero_i = torch.zeros_like(state["n_iter"])
        search = {
            "direction": direction, "g_dot_d": _dot(grad, direction), "t": t_init.to(dtype),
            "low": torch.zeros_like(one), "high": torch.full_like(one, math.inf),
            "f_new": state["f"].clone(), "g_new": grad.clone(), "theta_new": theta.clone(),
            "ls_accepted": already_opt | state["done"],
            "armijo_seen": torch.zeros_like(already_opt), "n_ls": zero_i, "ls_fev": zero_i.clone(),
            "already_opt": already_opt,
        }
        if "aux" in state:
            search["aux_new"] = state["aux"].clone()
        return search


def lbfgs_step(vag, st, cfg: LbfgsConfig, iter_limit) -> Dict[str, torch.Tensor]:
    """One objective evaluation of the state machine (module doc); returns
    the new state.  ``iter_limit`` (an int32 tensor) is the segment's
    absolute iteration limit: a lane with ``n_iter >= iter_limit`` or
    ``done`` is frozen."""
    with torch.no_grad():
        theta, f, grad = st["theta"], st["f"], st["grad"]
        direction, t = st["direction"], st["t"]
        frozen = st["done"] | (st["n_iter"] >= iter_limit)
        run = ~frozen & ~st["ls_accepted"]

        # one line-search trial on the clipped path
        theta_cand = _proj(theta + t[:, None] * direction, cfg)
        latent = "aux" in st
        if latent:
            # k Newton iterations of the trial in flight; the search moves
            # only for the lanes whose Newton loop has ended
            active = run
            f_cand, g_cand, carry, finished, worked = vag.trial(
                theta_cand, {k: st[k] for k in carry_fields(vag)}, run)
            run = run & finished
        else:
            f_cand, g_cand = vag(theta_cand)
        delta = theta_cand - theta
        finite = torch.isfinite(f_cand) & torch.isfinite(g_cand).all(-1)
        armijo = (f_cand <= f + cfg.armijo_c1 * _dot(grad, delta)) & finite
        curv = _dot(g_cand, direction) >= 0.9 * st["g_dot_d"]
        if theta.shape[-1]:
            moved = delta.abs().amax(-1) > 0
            saturated = (_proj(theta + (2.0 * t)[:, None] * direction, cfg) == theta_cand).all(-1)
        else:
            moved = torch.zeros_like(finite)
            saturated = torch.ones_like(finite)
        accept = armijo & moved & (curv | saturated)
        keep = run & (accept | (armijo & moved))
        high = torch.where(armijo, st["high"], t)
        low = torch.where(armijo & ~curv, t, st["low"])
        t_next = torch.where(armijo & ~curv,
                             torch.where(torch.isinf(high), t * 2.0, 0.5 * (low + high)),
                             0.5 * (low + high))
        ls = {
            "t": torch.where(run, torch.where(accept, t, t_next), t),
            "low": torch.where(run, low, st["low"]),
            "high": torch.where(run, high, st["high"]),
            "f_new": torch.where(keep, f_cand, st["f_new"]),
            "g_new": torch.where(keep[:, None], g_cand, st["g_new"]),
            "theta_new": torch.where(keep[:, None], theta_cand, st["theta_new"]),
            "ls_accepted": torch.where(run, accept, st["ls_accepted"]),
            "armijo_seen": st["armijo_seen"] | (run & armijo & moved),
            "n_ls": st["n_ls"] + run.to(torch.int32),
            "ls_fev": st["ls_fev"] + run.to(torch.int32),
        }
        if latent:
            keep_a = keep.view((-1,) + (1,) * (carry["nt_f"].dim() - 1))
            ls["aux_new"] = torch.where(keep_a, carry["nt_f"], st["aux_new"])
        ended = ~frozen & (ls["ls_accepted"] | (ls["n_ls"] >= cfg.max_ls))

        # the iteration's end: accept, update the history, test convergence
        accepted = ls["ls_accepted"] | ls["armijo_seen"]
        already_opt = st["already_opt"]
        s_vec = ls["theta_new"] - theta
        y_vec = ls["g_new"] - grad
        store = accepted & (_dot(s_vec, y_vec) > 1e-10)
        slot = st["hist_head"].long()
        sel = (torch.arange(cfg.m_hist, device=theta.device) == slot[:, None])[:, :, None]
        put = (store[:, None, None] & sel)
        s_hist = torch.where(put, s_vec[:, None, :], st["s_hist"])
        y_hist = torch.where(put, y_vec[:, None, :], st["y_hist"])
        head = torch.where(store, (st["hist_head"] + 1) % cfg.m_hist, st["hist_head"])
        count = torch.where(store, torch.clamp_max(st["hist_count"] + 1, cfg.m_hist),
                            st["hist_count"])
        f_change = (f - ls["f_new"]).abs() <= cfg.tol * torch.clamp_min(ls["f_new"].abs(), 1.0)
        g_small = _proj_grad_norm(ls["theta_new"], ls["g_new"], cfg) <= cfg.tol
        converged = (accepted & (f_change | g_small)) | already_opt
        stalled = ~accepted & ~already_opt
        fin = {
            "theta": ls["theta_new"], "f": ls["f_new"], "grad": ls["g_new"],
            "s_hist": s_hist, "y_hist": y_hist, "hist_count": count, "hist_head": head,
            "n_iter": st["n_iter"] + 1, "n_fev": st["n_fev"] + ls["ls_fev"],
            "done": converged | stalled, "stalled": stalled,
        }
        if latent:
            fin["aux"] = ls["aux_new"]
        nxt = prepare(fin, cfg)

        out = {"evaluations": st["evaluations"] + run.to(torch.int32)}
        for key in STATE_FIELDS:
            if key not in fin:
                continue
            new, old = fin[key], st[key]
            out[key] = torch.where(ended.view((-1,) + (1,) * (new.dim() - 1)), new, old)
        for key, new in nxt.items():
            old = ls[key] if key in ls else st[key]
            out[key] = torch.where(ended.view((-1,) + (1,) * (new.dim() - 1)), new, old)
        if latent:
            # a lane whose trial ended, or whose iteration ended, starts
            # its next trial's Newton loop from the modes of its iterate
            fresh = run | ended
            reset = vag.reset(out["aux"])
            for key in carry_fields(vag):
                new, old = reset[key], carry[key]
                out[key] = torch.where(fresh.view((-1,) + (1,) * (new.dim() - 1)), new, old)
            out["newton_iterations"] = st["newton_iterations"] + worked
            out["gradient_passes"] = st["gradient_passes"] + run.any().to(torch.int32)
            out["lane_steps"] = st["lane_steps"] + active.to(torch.int32)
        return out


def frozen_mask(state, iter_limit):
    """The lanes that are done or at ``iter_limit``."""
    return state["done"] | (state["n_iter"] >= iter_limit)


# --- running the step ---------------------------------------------------------


def graph_nodes(graph) -> Optional[int]:
    """The node count of a captured graph kept with ``keep_graph=True``
    (the driver API's ``cuGraphGetNodes``), or None where it cannot be
    read."""
    import ctypes

    try:
        raw = graph.raw_cuda_graph()
        lib = ctypes.CDLL("libcuda.so.1")
        count = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(count)) != 0:
            return None
        return int(count.value)
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None


class DeviceLoop:
    """Runs :func:`lbfgs_step` over a state until every lane is frozen.

    On a CUDA state (and ``capture=True``) the step is captured once into
    a CUDA graph over the state's static buffers, after a warm-up that
    must be an objective evaluation: the fit's initial one (``warm=True``:
    :func:`lbfgs_init_state` just ran it) or, for a state loaded from a
    checkpoint, one evaluation at its iterate on a side stream, whose
    result is discarded.
    Launches of the port's kernels inside the step are counted once per
    replay (``ops/cuda_lib.capture_tally``).  A capture that fails raises
    :class:`~spark_gp_tpu_torch.ops.cuda_lib.GraphCaptureError` (an
    out-of-memory error propagates as itself); nothing falls back to an
    eager loop on the card.  ``capture=False`` runs the step eagerly
    there: the check of the graph against it.  On the CPU the step always
    runs eagerly.

    ``counts``: ``captures``, ``replays``, ``eager_steps``,
    ``masked_evaluations`` (lane steps after the lane froze),
    ``host_syncs`` (reads of the frozen flags), ``capture_seconds``,
    ``graph_nodes`` and ``warmup_evaluations``; for a latent objective
    also ``newton_iterations`` and ``gradient_passes`` (device counts
    since the state was made: the Newton iterations and gradient passes
    in which some lane did work)."""

    def __init__(self, vag, state, cfg: LbfgsConfig, capture: bool = True, meter=None):
        self.vag = vag
        self.cfg = cfg
        self.state = state
        self.device = state["theta"].device
        self.use_graph = bool(capture) and self.device.type == "cuda"
        self.iter_limit = torch.zeros((), dtype=torch.int32, device=self.device)
        self.graph = None
        self.tally: dict = {}
        # metered cost of one step (obs/cost.py): counted at capture (or
        # the first eager step), one execution a replay or eager step; the
        # meter that measured the initial evaluation, when given
        self.meter = obs_cost.ReplayMeter("fit.device") if meter is None else meter
        self.counts = {
            "captures": 0, "replays": 0, "eager_steps": 0, "masked_evaluations": 0,
            "host_syncs": 0, "capture_seconds": 0.0, "graph_nodes": None,
            "warmup_evaluations": 0,
        }

    def capture(self, warm: bool) -> None:
        """Capture the step (class doc); ``warm``: the objective has
        already run on this state."""
        from spark_gp_tpu_torch.ops import cuda_lib

        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        if not warm:
            # a loaded state: warm the capture with one evaluation
            with torch.cuda.stream(side), torch.no_grad():
                if is_latent(self.vag):
                    self.vag.evaluate(self.state["theta"].clone(), self.state["aux"].clone())
                else:
                    self.vag(self.state["theta"].clone())
            self.counts["warmup_evaluations"] += 1
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            # thread_local: another thread's CUDA calls (a serving thread
            # replaying or freeing its graphs) must not invalidate the
            # capture, and no garbage collection runs finalizers on this
            # thread during it; this thread's host reads still fail.  The
            # backward runs on this thread too (autograd's device threads
            # off), so a kernel it launches (K2-VJP) tallies in the
            # capture's record, which is this thread's
            with cuda_lib.capture_tally() as tally, cuda_lib.collector_held(), \
                    torch.autograd.set_multithreading_enabled(False):
                with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                        self.meter.capturing():
                    new = lbfgs_step(self.vag, self.state, self.cfg, self.iter_limit)
                    for key, buf in self.state.items():
                        buf.copy_(new[key])
            graph.instantiate()
        except torch.cuda.OutOfMemoryError:
            raise
        except (RuntimeError, cuda_lib.KernelLaunchError) as exc:
            raise cuda_lib.GraphCaptureError(
                f"the device optimizer's step could not be captured into a CUDA graph: {exc}"
            ) from exc
        self.graph, self.tally = graph, dict(tally)
        self.counts["graph_nodes"] = graph_nodes(graph)
        self.counts["captures"] += 1
        self.counts["capture_seconds"] += time.perf_counter() - t0

    def _snapshot(self):
        """One host read: whether every lane is frozen, and the lanes'
        steps that were not masked so far (their evaluations; for a latent
        objective their steps, a trial taking one or more, and the device
        counts of Newton iterations and gradient passes, which land in
        ``counts``)."""
        self.counts["host_syncs"] += 1
        frozen = frozen_mask(self.state, self.iter_limit).all().to(torch.int64)
        latent = "aux" in self.state
        steps = self.state["lane_steps" if latent else "evaluations"].sum().to(torch.int64)
        read = [frozen, steps]
        if latent:
            read += [self.state["newton_iterations"].to(torch.int64),
                     self.state["gradient_passes"].to(torch.int64)]
        snap = torch.stack(read).cpu().tolist()
        if latent:
            self.counts["newton_iterations"], self.counts["gradient_passes"] = snap[2], snap[3]
        return bool(snap[0]), int(snap[1])

    def advance(self, iter_limit: int, warm: bool = False) -> Dict[str, torch.Tensor]:
        """Step until every lane is done or at ``iter_limit`` (an absolute
        count, so a host loop can run the same captured step in segments,
        persisting the state between them); returns the state (its
        buffers, updated in place on the graph path)."""
        from spark_gp_tpu_torch.ops import cuda_lib

        self.iter_limit.fill_(int(iter_limit))
        lanes = int(self.state["theta"].shape[0])
        frozen, evals = self._snapshot()
        while not frozen:
            if self.use_graph:
                if self.graph is None:
                    self.capture(warm)
                with self.meter.replays(REPLAY_BATCH):
                    for _ in range(REPLAY_BATCH):
                        self.graph.replay()
                    cuda_lib.count_replays(self.tally, REPLAY_BATCH)
                self.counts["replays"] += REPLAY_BATCH
                steps = REPLAY_BATCH
            else:
                with self.meter.eager_step():
                    self.state = lbfgs_step(self.vag, self.state, self.cfg, self.iter_limit)
                self.counts["eager_steps"] += 1
                steps = 1
            frozen, now = self._snapshot()
            self.counts["masked_evaluations"] += steps * lanes - (now - evals)
            evals = now
        return self.state

    def release(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def host_state(state, lane: int = 0) -> _LbfgsState:
    """One lane of a device state as the JAX package's ``_LbfgsState`` in
    numpy (the checkpoint payload's leaves; ``aux`` the lane's latent
    modes, or the zero scalar of an objective without them)."""
    get = {k: state[k][lane].detach().cpu().numpy() for k in STATE_FIELDS if k in state}
    if "aux" not in get:
        get["aux"] = np.zeros((), dtype=get["f"].dtype)
    return _LbfgsState(**{k: get[k] for k in STATE_FIELDS})


def device_state(host: _LbfgsState, cfg: LbfgsConfig, device, vag=None) -> Dict[str, torch.Tensor]:
    """A one-lane device state from a host ``_LbfgsState`` (a checkpoint),
    its next iteration prepared; no objective is evaluated.  A latent
    objective ``vag`` takes the saved modes as its ``aux`` (a save falls
    on an iteration boundary, so the Newton carry is the modes')."""
    state = {}
    for key in STATE_FIELDS:
        if key == "aux":
            continue
        state[key] = torch.as_tensor(np.asarray(getattr(host, key)), device=device)[None].clone()
    state["evaluations"] = torch.zeros_like(state["n_iter"])
    if vag is not None and is_latent(vag):
        aux = torch.as_tensor(np.asarray(host.aux), device=device)[None].clone()
        state.update(_latent_fields(vag, aux))
    state.update(prepare(state, cfg))
    return state


def state_template(h: int, dtype, m_hist: int = 10, aux_shape=()) -> dict:
    """``{field: (shape, numpy dtype)}`` of one lane's ``_LbfgsState``:
    what a checkpoint must hold to resume a fit with ``h`` hyperparameters
    in ``dtype`` (and latent modes of ``aux_shape``)."""
    fdt = np.dtype(str(dtype).replace("torch.", ""))
    return {
        "theta": ((h,), fdt), "f": ((), fdt), "grad": ((h,), fdt), "aux": (tuple(aux_shape), fdt),
        "s_hist": ((m_hist, h), fdt), "y_hist": ((m_hist, h), fdt),
        "hist_count": ((), np.dtype(np.int32)), "hist_head": ((), np.dtype(np.int32)),
        "n_iter": ((), np.dtype(np.int32)), "n_fev": ((), np.dtype(np.int32)),
        "done": ((), np.dtype(bool)), "stalled": ((), np.dtype(bool)),
    }


# --- entry points -------------------------------------------------------------


def lbfgs_minimize_device(vag, theta0, lower, upper, max_iter: int = 100, tol: float = 1e-6,
                          m_hist: int = 10, max_ls: int = 25, armijo_c1: float = 1e-4,
                          capture: bool = True, loop_metrics: Optional[dict] = None):
    """Minimize a lanes objective ``vag(theta [R, h]) -> (f [R], g [R, h])``
    from ``theta0 [h]`` (one lane) within ``[lower, upper]``.  Returns
    ``(theta, f, n_iter, n_fev, stalled)`` as device tensors.

    Convergence is the JAX loop's: projected-gradient inf-norm <= tol, or
    a relative objective change <= tol between accepted iterates.
    ``stalled`` is True when the loop ended because the line search found
    no acceptable step: the iterate is the best seen, not a certified
    optimum.  ``loop_metrics``, a dict, receives the loop's metrics."""
    out = lbfgs_minimize_device_lanes(vag, theta0[None], lower, upper, max_iter, tol, m_hist,
                                      max_ls, armijo_c1, capture, loop_metrics)
    return tuple(v[0] for v in out)


def lbfgs_minimize_device_lanes(vag, theta0, lower, upper, max_iter: int = 100,
                                tol: float = 1e-6, m_hist: int = 10, max_ls: int = 25,
                                armijo_c1: float = 1e-4, capture: bool = True,
                                loop_metrics: Optional[dict] = None):
    """:func:`lbfgs_minimize_device` over ``[R, h]`` starting points, every
    lane with its own diagnostics: ``(theta [R, h], f [R], n_iter [R],
    n_fev [R], stalled [R])``."""
    final = lbfgs_run_lanes(vag, theta0, lower, upper, max_iter, tol, m_hist, max_ls, armijo_c1,
                            capture, loop_metrics)
    return tuple(final[k] for k in ("theta", "f", "n_iter", "n_fev", "stalled"))


def lbfgs_run_lanes(vag, theta0, lower, upper, max_iter: int = 100, tol: float = 1e-6,
                    m_hist: int = 10, max_ls: int = 25, armijo_c1: float = 1e-4,
                    capture: bool = True, loop_metrics: Optional[dict] = None, aux0=None):
    """The loop of :func:`lbfgs_minimize_device_lanes` from ``[R, h]``
    starting points (a latent objective from the modes ``aux0``); returns
    a copy of the final state dict."""
    if max_ls < 1:
        raise ValueError("max_ls must be >= 1")
    cfg = LbfgsConfig(lower=lower, upper=upper, tol=float(tol), m_hist=int(m_hist),
                      max_ls=int(max_ls), armijo_c1=float(armijo_c1))
    meter = obs_cost.ReplayMeter("fit.device")
    with meter.initial():
        state = lbfgs_init_state(vag, theta0, cfg, aux0)
    loop = DeviceLoop(vag, state, cfg, capture=capture, meter=meter)
    try:
        final = loop.advance(int(max_iter), warm=True)
        result = {k: v.clone() for k, v in final.items()}
    finally:
        meter.finish()
        loop.release()
        if loop_metrics is not None:
            loop_metrics.update(loop.counts)
    return result


def lbfgs_minimize_device_multistart(vag, theta0_batch, lower, upper, max_iter: int = 100,
                                     tol: float = 1e-6, m_hist: int = 10,
                                     loop_metrics: Optional[dict] = None):
    """All R restarts as one lockstep loop over ``[R, h]`` starting points
    (module doc).  Returns ``(theta_best, f_best, n_iter_best, n_fev_best,
    stalled_best, f_all [R], best)``: the winner is the lowest finite
    final objective (a non-finite lane ranks +inf), chosen on the device,
    with its own diagnostics."""
    thetas, fs, iters, fevs, stalls = lbfgs_minimize_device_lanes(
        vag, theta0_batch, lower, upper, max_iter, tol, m_hist, loop_metrics=loop_metrics)
    ranked = torch.where(torch.isfinite(fs), fs, torch.full_like(fs, math.inf))
    best = torch.argmin(ranked)
    return thetas[best], fs[best], iters[best], fevs[best], stalls[best], fs, best


def multistart_minimize(vag, log_space: bool, theta0_batch, lower, upper, max_iter, tol,
                        loop_metrics: Optional[dict] = None):
    """Every family's batched multi-start: the optional log-space
    reparameterization around :func:`lbfgs_minimize_device_multistart`.
    Returns ``(theta_best, f_best, n_iter, n_fev, stalled, f_all [R],
    best)`` in the original coordinates."""
    from_u = (lambda t: t)
    if log_space:
        vag, theta0_batch, lower, upper, from_u = log_reparam(vag, theta0_batch, lower, upper)
    theta, f, n_iter, n_fev, stalled, f_all, best = lbfgs_minimize_device_multistart(
        vag, theta0_batch, lower, upper, max_iter=max_iter, tol=tol, loop_metrics=loop_metrics)
    return from_u(theta), f, n_iter, n_fev, stalled, f_all, best
