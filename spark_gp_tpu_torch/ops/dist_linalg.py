"""The row-sharded dense Cholesky and its triangular solves over the
expert mesh (the JAX package's ``ops/dist_linalg.py``).

The PPA magic solve factors two ``[m, m]`` matrices.  Over a mesh of
several ranks the factorization itself is split: each rank holds a
contiguous block of ``m / world`` rows (the layout ``parallel/mesh.
shard_experts`` gives the expert axis), so the O(m^3) factorization
scales with the ranks and no rank holds the whole matrix while it
factors.

**Factorization** -- right-looking and blocked.  For each ``b``-wide
panel ``k``:

1. ``A_kk``: the owner's ``[b, b]`` diagonal block, all-reduced (the other
   ranks add zeros, so every rank receives the owner's block bit for bit);
2. ``L_kk = cholesky(A_kk)`` on every rank, redundantly (``b x b``);
3. ``X = A[:, panel] L_kk^-T`` on each rank's own rows below the panel;
4. the panel's columns written: ``L_kk`` on the panel's rows, ``X`` below,
   zeros above;
5. the ``[m, b]`` column below the panel all-gathered;
6. the trailing update ``A[:, past the panel] -= X L_col^T``, one local
   matrix product.

**Solves** walk the same panels with a replicated ``[m, r]`` right-hand
side: forward, each panel's column of ``L`` all-gathered (its diagonal
block among it) and the update below it applied on every rank; backward,
the panel's row block of ``L`` all-reduced from its owner and the update
above it applied on every rank.  Every collective is a copy (a gather, or
a sum of one rank's block with zeros), so every rank holds the same
solution bit for bit.  The JAX package gathers each panel's ``[m, r]``
contribution instead; with ``r = m`` (the magic matrix's identity
right-hand side) that is ``m`` times ``r / b`` more traffic than the
factor's ``[m, b]`` column, which is what crosses here.

**Tripwire** -- step 2 computes every ``L_kk`` on every rank; for the
panels in the integrity plane's sample (``resilience/integrity.
panel_checked``) the ranks gather their copies and compare them: honest
copies of one block factored by one program are identical, so any
difference is corruption.  Every rank computes the same verdict from the
same gathered copies and raises the same
:class:`~spark_gp_tpu_torch.resilience.integrity.PanelMismatchError`, naming
the rank whose copy fails to reproduce ``A_kk`` (``L L^T`` against the
block).  The JAX package compares each copy against the ranks' mean: two
ranks are then equidistant from it, and ``(x + x + x) / 3`` need not be
``x``, so the mean cannot name the rank of a pair nor give an honest
difference of exactly 0.

Indefiniteness shows as NaN in the factor (as the JAX package's): check it
with :func:`all_finite` before trusting a solve.  Padding: the caller pads
``m`` to a multiple of ``world * block`` with :func:`pad_spd`.  The
factorizations are library calls (``torch.linalg``: cuSOLVER and cuBLAS on
the card) and the collectives the group's (NCCL or gloo); inputs are
float64, and nothing here is differentiated.
"""

from __future__ import annotations

import numpy as np
import torch

#: relative cross-rank difference of checked panel copies past which they
#: are declared corrupted; honest copies are identical, so the bar only has
#: to sit above 0
PANEL_DIVERGENCE_BAR = 1e-12


def _check_granularity(m: int, mesh, block: int) -> None:
    if m % (mesh.world_size * block) != 0:
        raise ValueError(
            f"m={m} must be a multiple of world_size*block={mesh.world_size * block}; "
            "pad with an identity diagonal block (pad_spd)")


def sharded_cholesky(mesh, a: torch.Tensor, block: int = 128) -> torch.Tensor:
    """The lower Cholesky factor of the SPD ``[m, m]`` matrix ``a``, row
    sharded over ``mesh``: returns this rank's ``[m / world, m]`` rows of
    ``L``.  ``a`` is the same on every rank (the JAX package's calling
    convention), and each rank reads its own rows.  ``m`` must be a
    multiple of ``world * block`` (``ValueError`` otherwise, before any
    collective).

    With the integrity plane on (``GP_INTEGRITY``), the sampled panels
    (``GP_INTEGRITY_PANEL_SAMPLE``) are compared across the ranks, counted
    in ``integrity.panel_checks``; a difference raises
    :class:`~spark_gp_tpu_torch.resilience.integrity.PanelMismatchError`
    on every rank.  A staged ``chaos.corrupt_device(rank)`` scales that
    rank's copies of every ``L_kk``, which then flow into its rows."""
    from spark_gp_tpu_torch.resilience import chaos, integrity

    m = a.shape[-1]
    _check_granularity(m, mesh, block)
    world, rank = mesh.world_size, mesh.rank
    m_loc, b = m // world, block
    base = rank * m_loc
    a_loc = a[base:base + m_loc].clone()
    rate = integrity.panel_sample_rate() if integrity.enabled() else 0.0
    checked = {k for k in range(m // b) if integrity.panel_checked(k, rate)}
    staged = chaos.staged_device_corruption()
    corrupt = None if staged is None or staged[0] != rank else staged[1]
    # the verdict's operands, on the device until the end: the largest
    # difference seen, whether one passed the bar, and each copy's misfit
    # at the first panel where one did
    spread, found = a_loc.new_zeros(()), torch.zeros((), dtype=torch.bool, device=a_loc.device)
    misfit = a_loc.new_zeros(world)
    nan = torch.tensor(float("nan"), dtype=a_loc.dtype, device=a_loc.device)
    for k in range(m // b):
        r0, r1 = k * b, (k + 1) * b
        owner, p0 = divmod(r0, m_loc)
        diag = a_loc[p0:p0 + b, r0:r1] if owner == rank else a_loc.new_zeros((b, b))
        a_kk = mesh.all_reduce(diag)
        l_kk, info = torch.linalg.cholesky_ex(a_kk)
        l_kk = torch.where(info == 0, l_kk, nan)
        if corrupt is not None:
            l_kk = l_kk * corrupt
        if k in checked:
            spread, found, misfit = _check_panel(mesh, l_kk, a_kk, spread, found, misfit)
        if rank < owner:
            # every row of this rank lies above the panel
            a_loc[:, r0:r1] = 0.0
            below = a_loc.new_zeros((m_loc, b))
        else:
            start = p0 + b if rank == owner else 0
            x = torch.linalg.solve_triangular(l_kk.mT, a_loc[start:, r0:r1], upper=True,
                                              left=False)
            below = a_loc.new_zeros((m_loc, b))
            below[start:] = x
            a_loc[:, r0:r1] = below
            if rank == owner:
                a_loc[p0:p0 + b, r0:r1] = l_kk
        column = torch.cat(mesh.all_gather(below))  # [m, b]
        if r1 < m and rank >= owner:
            a_loc[:, r1:] -= below @ column[r1:].mT
    if checked:
        _panel_verdict(spread, found, misfit, len(checked))
    # the trailing updates leave values above the diagonal
    return torch.tril(a_loc, diagonal=base)


def _check_panel(mesh, l_kk, a_kk, spread, found, misfit):
    """One sampled panel's comparison: the ranks' ``L_kk`` copies gathered,
    their largest relative difference (a copy finite where another is not
    differs infinitely; copies NaN alike, as every rank's factor of one
    indefinite block is, agree), and at the first panel past the bar each
    copy's misfit to its block (``L L^T`` against ``A_kk``; NaN counts as
    infinite).  A NaN in a later panel cannot erase an earlier verdict."""
    copies = torch.stack(mesh.all_gather(l_kk))  # [world, b, b]
    finite = torch.isfinite(copies)
    vals = torch.where(finite, copies, 0.0)
    gap = (vals.amax(0) - vals.amin(0)).amax() / (vals.abs().amax() + 1e-30)
    gap = torch.where((finite == finite[:1]).all(), gap, torch.full_like(gap, float("inf")))
    refit = (copies @ copies.mT - a_kk).abs().amax((1, 2)) / (a_kk.abs().amax() + 1e-30)
    refit = torch.nan_to_num(refit, nan=float("inf"))
    first = (gap > PANEL_DIVERGENCE_BAR) & ~found
    return (torch.maximum(spread, gap), found | first, torch.where(first, refit, misfit))


def _panel_verdict(spread: torch.Tensor, found: torch.Tensor, misfit: torch.Tensor,
                   checked: int) -> None:
    """Count the checked panels, record their largest cross-rank
    difference (``integrity.panel_spread``) and raise on one past the bar,
    naming the rank whose copy misfit its block most at the first such
    panel (every rank computes this from the same gathered copies, so
    every rank raises alike)."""
    from spark_gp_tpu_torch.obs import trace as obs_trace
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.resilience.integrity import PanelMismatchError

    telemetry.inc("integrity.panel_checks", n=float(checked))
    host = torch.cat([spread[None], found[None].to(spread.dtype), misfit]).cpu().numpy()
    worst = float(host[0])
    telemetry.set_gauge("integrity.panel_spread", worst)
    if not host[1]:
        return
    suspect = int(np.argmax(host[2:]))
    telemetry.inc("integrity.panel_mismatch")
    obs_trace.add_event("integrity.panel_mismatch", rank=suspect, rel=worst, checked=checked)
    raise PanelMismatchError(
        f"sharded Cholesky: {checked} sampled diagonal panel(s) differ across the ranks "
        f"(largest relative difference {worst:.3e}; rank {suspect}'s copy does not "
        "reproduce its block): copies of one all-reduced block factored by one program "
        "must be identical, so a rank corrupted the solve silently",
        pid=suspect, code="panel_divergence")


def sharded_chol_solve(mesh, l_loc: torch.Tensor, rhs: torch.Tensor,
                       block: int = 128) -> torch.Tensor:
    """``A^-1 rhs`` from this rank's rows ``l_loc`` of ``A``'s factor
    (:func:`sharded_cholesky`); ``rhs`` ``[m]`` or ``[m, r]`` is the same on
    every rank, and so is the solution returned (same shape)."""
    m_loc, m = l_loc.shape
    _check_granularity(m, mesh, block)
    b = block
    y = (rhs[:, None] if rhs.ndim == 1 else rhs).to(l_loc.dtype).clone()
    for k in range(m // b):
        # forward: L y = rhs, the panel's column of L gathered
        r0, r1 = k * b, (k + 1) * b
        column = torch.cat(mesh.all_gather(l_loc[:, r0:r1].contiguous()))  # [m, b]
        y_k = torch.linalg.solve_triangular(column[r0:r1], y[r0:r1], upper=False)
        y[r0:r1] = y_k
        if r1 < m:
            y[r1:] -= column[r1:] @ y_k
    for k in reversed(range(m // b)):
        # backward: L^T x = y, the panel's row block of L from its owner
        r0, r1 = k * b, (k + 1) * b
        owner, p0 = divmod(r0, m_loc)
        rows = l_loc[p0:p0 + b, :r1] if owner == mesh.rank else l_loc.new_zeros((b, r1))
        rows = mesh.all_reduce(rows)
        x_k = torch.linalg.solve_triangular(rows[:, r0:r1].mT, y[r0:r1], upper=True)
        y[r0:r1] = x_k
        if r0:
            y[:r0] -= rows[:, :r0].mT @ x_k
    return y[:, 0] if rhs.ndim == 1 else y


def all_finite(mesh, *local: torch.Tensor) -> list:
    """For each of this rank's tensors, whether it is finite on every rank:
    one all-reduce and one host read, the same answer on every rank."""
    bad = torch.stack([(~torch.isfinite(t)).any().to(torch.float64) for t in local])
    return [flag == 0.0 for flag in mesh.all_reduce(bad, "max").cpu().tolist()]


def pad_spd(a, m_pad: int):
    """``a`` (``[m, m]``, numpy or a tensor) embedded in an ``[m_pad, m_pad]``
    identity: padded rows factor to ``e_i`` and zero right-hand-side rows
    solve to zero, so results slice back exactly."""
    m = a.shape[0]
    if isinstance(a, torch.Tensor):
        out = torch.eye(m_pad, dtype=a.dtype, device=a.device)
    else:
        out = np.eye(m_pad, dtype=a.dtype)
    out[:m, :m] = a
    return out
