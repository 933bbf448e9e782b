"""Greedy (Seeger et al. 2003) active-set forward selection, the port of
the JAX package's ``models/greedy.py`` on one device.

The active set grows one point a round, each candidate scored by the
information-gain delta of *Fast Forward Selection to Speed Up Sparse
Gaussian Process Regression* (ASP.scala:106-128):

    li^2  = K_ii - k_i^T Kmm^-1 k_i
    q_i   = k_i^T (sigma2 Kmm + Kmn Knm)^-1 k_i
    mu_i  = k_i^T magicVector
    delta = -log(sigma/li) - (log ksi + ksi (1-kappa)/sigma2 (y_i-mu_i)^2
                              - kappa + 2) / 2

Appending a point extends ``Kmm`` and ``sigma2 Kmm + Kmn Knm`` by one row
and column, so each round extends their two Cholesky factors by one row
(two triangular solves against the ``[m, m]`` factors) and updates the
candidate statistics ``p = rowsum(W^2)``, ``q = rowsum(V^2)``,
``mu = V^T z`` from the new factor rows, which need only the stored cross
rows ``K_sel [m, N]`` of the chosen points:

    w_row = (c_new - (L_mm^-T w)^T K_sel) / d
    v_row = (c_new - (L_pd^-T v)^T K_sel) / e

The m - 1 rounds are a Python loop over device tensors: the winning index
stays on the device, so a round is a fixed set of launches and no host
read.  NaN scores (li^2 <= 0 under rounding), chosen points and masked
slots score ``-inf``; ``torch.argmax`` takes the lowest index on ties.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel
from spark_gp_tpu_torch.utils.device import resolve_device, working_dtype


def _solve(l_mat, b):
    """``L^-1 b`` for a lower-triangular ``L`` and a vector ``b``."""
    return torch.linalg.solve_triangular(l_mat, b[:, None], upper=False)[:, 0]


def _solve_t(l_mat, b):
    """``L^-T b`` for a lower-triangular ``L`` and a vector ``b``."""
    return torch.linalg.solve_triangular(l_mat.mT, b[:, None], upper=True)[:, 0]


@torch.no_grad()
def _greedy_core(kernel: Kernel, m: int, theta, xf, yf, maskf, first_idx, mesh=None):
    """Forward selection over the candidates ``xf [n, p]``, ``yf [n]``,
    ``maskf [n]`` from the seed row ``first_idx`` (a 0-d device tensor);
    returns ``(points [m, p], indices [m], winning deltas [m])``, the
    deltas NaN for the seed round, which has no score.

    With ``mesh`` the candidates are this rank's block of a stack whose
    blocks are the ranks' in rank order, ``first_idx`` and the returned
    indices are global flat indices, and a round costs four collectives
    (the JAX package's sharded rounds): one sum of every statistic of the
    chosen point (its row, its ``K_mm`` column and diagonal entry), one
    sum of the cross-row products, and the distributed argmax (the largest
    delta, the lowest global index on ties)."""
    n = xf.shape[0]
    dtype, device = xf.dtype, xf.device
    base = 0 if mesh is None else mesh.rank * n
    gids = torch.arange(n, device=device) + base
    p = xf.shape[1]
    sigma2 = kernel.white_noise_var(theta).to(dtype)
    k_diag = kernel.diag(theta, xf)  # includes the +sigma2 noise diagonal
    k_diag_masked = k_diag * maskf

    ksel = torch.zeros((m, n), dtype=dtype, device=device)  # cross rows of the chosen
    l_mm = torch.eye(m, dtype=dtype, device=device)  # unit diagonal on unfilled rows
    l_pd = torch.eye(m, dtype=dtype, device=device)
    z = torch.zeros(m, dtype=dtype, device=device)  # L_pd^-1 K_mn y
    p_vec = torch.zeros(n, dtype=dtype, device=device)
    q_vec = torch.zeros(n, dtype=dtype, device=device)
    mu_vec = torch.zeros(n, dtype=dtype, device=device)
    sel = torch.zeros(n, dtype=torch.bool, device=device)
    chosen = torch.zeros(m, dtype=torch.long, device=device)
    chosen_x = torch.zeros((m, p), dtype=dtype, device=device)
    deltas = torch.full((m,), torch.nan, dtype=dtype, device=device)

    def append(k, gidx):
        nonlocal p_vec, q_vec, mu_vec, sel
        if mesh is None:
            at = gidx.reshape(1)
            x_sel = xf.index_select(0, at)[0]
            kmm_col = ksel.index_select(1, at)[:, 0]  # zeros past k: identity-padded
            kmm_nn = k_diag_masked.index_select(0, at)[0]  # factors forward-solve to 0
        else:
            onehot = (gids == gidx).to(dtype)
            fused = mesh.all_reduce(torch.cat([onehot @ xf, ksel @ onehot,
                                               (k_diag_masked @ onehot).reshape(1)]))
            x_sel, kmm_col, kmm_nn = fused[:p], fused[p:p + m], fused[p + m]
        # the Eye (noise) part of the model kernel is 0 off its training
        # set; masked so padded slots never feed the statistics
        c_new = kernel.cross(theta, x_sel[None, :], xf)[0] * maskf
        cross = torch.cat([ksel @ c_new, (c_new @ c_new).reshape(1), (c_new @ yf).reshape(1)])
        if mesh is not None:
            cross = mesh.all_reduce(cross)
        ksel_c, c_c, c_y = cross[:m], cross[m], cross[m + 1]

        w = _solve(l_mm, kmm_col)
        d = torch.sqrt(kmm_nn - w @ w)
        # row k of W = L_mm^-1 K_sel by the transpose-solve identity, from
        # the factor before the update (w is zero past k)
        w_row = (c_new - _solve_t(l_mm, w) @ ksel) / d
        w[k] = d
        l_mm[k] = w
        p_vec = p_vec + w_row * w_row

        pd_col = sigma2 * kmm_col + ksel_c
        pd_nn = sigma2 * kmm_nn + c_c
        v = _solve(l_pd, pd_col)
        e = torch.sqrt(pd_nn - v @ v)
        v_row = (c_new - _solve_t(l_pd, v) @ ksel) / e
        v[k] = e
        l_pd[k] = v
        q_vec = q_vec + v_row * v_row

        z_k = (c_y - v[:k] @ z[:k]) / e
        z[k] = z_k
        mu_vec = mu_vec + v_row * z_k

        ksel[k] = c_new
        sel = sel | (gids == gidx)
        chosen[k] = gidx
        chosen_x[k] = x_sel

    append(0, first_idx)
    for k in range(1, m):
        li2 = k_diag - p_vec
        ratio2 = sigma2 / li2  # (sigma / li)^2
        ksi = 1.0 / (ratio2 + 1.0 - q_vec)
        kappa = ksi * (1.0 + 2.0 * ratio2)
        delta = -0.5 * torch.log(ratio2) - 0.5 * (
            torch.log(ksi)
            + ksi * (1.0 - kappa) / sigma2 * (yf - mu_vec) ** 2
            - kappa
            + 2.0
        )
        delta = torch.where(torch.isnan(delta) | sel | (maskf == 0), -torch.inf, delta)
        loc = torch.argmax(delta)
        best = delta.index_select(0, loc.reshape(1))
        if mesh is None:
            gidx = loc
        else:
            best = mesh.all_reduce(best, "max")
            tied = torch.where(delta.index_select(0, loc.reshape(1)) == best,
                               gids.index_select(0, loc.reshape(1)),
                               torch.full_like(loc.reshape(1), torch.iinfo(torch.int64).max))
            gidx = mesh.all_reduce(tied, "min")[0]
        deltas[k] = best[0]
        append(k, gidx)
    return chosen_x, chosen, deltas


def warn_on_flat_delta_profile(deltas: np.ndarray):
    """The JAX package's diagnostic for the regime where Seeger selection
    hurts (late picks remote in kernel space, the airfoil-at-small-m
    pathology): the median of the last third of the winning deltas over
    the median of the first third.  At 0.95 or above it logs a warning on
    the ``spark_gp_tpu_torch`` logger.  Returns the ratio, or None when
    fewer than 9 rounds are finite or the head median is not positive."""
    d = np.asarray(deltas, dtype=np.float64)
    d = d[np.isfinite(d)]
    if d.size < 9:  # < 3 per third: medians too noisy to accuse anyone
        return None
    third = d.size // 3
    head = float(np.median(d[:third]))
    tail = float(np.median(d[-third:]))
    if head <= 0.0:
        return None
    ratio = tail / head
    if ratio >= 0.95:
        logging.getLogger("spark_gp_tpu_torch").warning(
            "greedy active-set selection: winning information-gain deltas "
            "are not decaying (tail/head median ratio %.2f over %d rounds) "
            "— late picks look remote in kernel space and likely contribute "
            "nothing (the airfoil-at-small-m pathology, PARITY.md). "
            "RandomActiveSetProvider (the reference default) or "
            "KMeansActiveSetProvider will likely fit better here.",
            ratio, d.size,
        )
    return ratio


def greedy_active_set(active_set_size: int, x, y, kernel: Kernel, theta_opt, seed: int,
                      device=None) -> np.ndarray:
    """The ``[m, p]`` greedy active set over the host rows ``x [n, p]``,
    ``y [n]``, selected on ``device`` (``None`` means ``cuda``) in its
    working dtype from the seed row ``np.random.default_rng(seed)
    .integers(n)`` (the JAX package's).  ``kernel`` must be the
    noise-augmented model kernel.  Returns host rows of ``x``, not the
    device values, which would be rounded to the device dtype before the
    float64 magic solve; warns on a flat delta profile."""
    x = np.asarray(x)
    n = x.shape[0]
    m = min(active_set_size, n)
    device = resolve_device(device)
    dtype = working_dtype(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    first = int(np.random.default_rng(seed).integers(n))
    _, idx, deltas = _greedy_core(
        kernel, m, put(theta_opt), put(x), put(y), torch.ones(n, dtype=dtype, device=device),
        torch.tensor(first, device=device),
    )
    warn_on_flat_delta_profile(deltas.cpu().numpy())
    return x[idx.cpu().numpy()]


def greedy_active_set_from_stack(active_set_size: int, data, kernel: Kernel, theta, seed: int,
                                 mesh) -> np.ndarray:
    """Greedy selection straight off a rank-local stack (the JAX package's
    ``greedy_active_set_from_stack``): the candidate statistics stay on
    their rank for all m rounds and only the chosen rows are summed
    across ranks (:func:`_greedy_core` with ``mesh``).  The seed is
    ``np.random.default_rng(seed).choice`` over the stack's real rows in
    global order (``parallel/distributed.replicated_valid_indices``), the
    targets whatever ``data.y`` carries (labels, or a classifier's latent
    modes).  Returns ``[m, p]`` float64, the same on every rank; ``mesh``
    None selects over a stack that is whole here."""
    from spark_gp_tpu_torch.parallel.distributed import replicated_valid_indices

    valid = replicated_valid_indices(data, mesh)
    m = min(int(active_set_size), valid.size)
    first = int(np.random.default_rng(seed).choice(valid))
    device, dtype = data.x.device, data.x.dtype
    p = data.x.shape[-1]
    theta_dev = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=dtype, device=device)
    chosen_x, _, deltas = _greedy_core(
        kernel, m, theta_dev, data.x.reshape(-1, p), data.y.reshape(-1).to(dtype),
        data.mask.reshape(-1).to(dtype), torch.tensor(first, device=device), mesh)
    warn_on_flat_delta_profile(deltas.cpu().numpy())
    return chosen_x.to(torch.float64).cpu().numpy()
