"""Product-of-experts predictive aggregation (the BCM family), the JAX
package's ``models/poe.py``.

The PPA predictor (``models/ppa.py``) answers through an m-point inducing
set.  This module predicts from the fit's own expert split instead: each
expert answers from its exact s-point posterior, and the answers combine
by precision weighting (Deisenroth and Ng, ICML'15; "Healing Products of
Gaussian Processes", arXiv:2102.07106):

    poe    prec = sum_e 1/s2_e                      (overconfident in voids)
    gpoe   prec = sum_e b_e/s2_e,  b_e = 1/E
    bcm    poe + (1-E)/k**  prior correction
    rbcm   b_e = 0.5(log k** - log s2_e) per point
           prec = sum_e b_e/s2_e + (1-sum_e b_e)/k**
    healed b_e = max(0, rbcm weight), normalized:
           prec = sum_e b_e/s2_e / sum_e b_e, the prior where no expert
           carries information

with ``k**`` the prior variance ``kernel.self_diag`` (noise included, as
in the PPA variance).  ``mode=None`` resolves the aggregation plane's
policy (``models/aggregation.py``) when one is engaged, else ``rbcm``.

The per-expert Cholesky factors ``[E, s, s]`` are built once (the
training objective's masked gram embedding keeps padding inert);
prediction is one batched triangular solve and the reduction, on the
stack's device, streamed over test chunks.  The factors stay on
``cholesky`` and triangular solves, as in the JAX package: the
per-expert variance ``k** - k^T K^-1 k`` cancels down to the noise
level, and a triangular solve's error grows with sqrt(kappa) where an
explicit inverse's grows with kappa.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import Kernel, masked_gram_stack
from spark_gp_tpu_torch.ops.linalg import (
    JITTER_SCHEDULE,
    chol_solve,
    cholesky,
    cholesky_escalated,
    is_pd,
)
from spark_gp_tpu_torch.parallel.experts import ExpertData
from spark_gp_tpu_torch.utils.device import resolve_device, working_dtype

_MODES = ("poe", "gpoe", "bcm", "rbcm", "healed")


def _local_moments(kernel: Kernel, mode, theta, x, mask, chol_l, alpha, x_test, k_ss):
    """The expert reduction: ``(sum(beta * prec), sum(beta * prec * mean),
    sum(beta), n_alive)`` over the expert axis, ``[t]`` each but the
    count."""
    e = x.shape[0]
    k_cross = kernel.cross(theta, x_test.expand((e,) + x_test.shape), x) * mask[:, None, :]
    mean_e = torch.einsum("ets,es->et", k_cross, alpha)  # [E, t]
    v = torch.linalg.solve_triangular(chol_l, k_cross.mT, upper=False)  # [E, s, t]
    var_e = k_ss[None, :] - torch.sum(v * v, dim=1)
    # fully masked experts (quarantined or padding) get no vote
    alive = (torch.sum(mask, dim=1) > 0).to(k_ss.dtype)[:, None]  # [E, 1]
    n_alive = torch.sum(alive)
    prec_e = alive / var_e
    if mode in ("rbcm", "healed"):
        beta = alive * 0.5 * (torch.log(k_ss)[None, :] - torch.log(var_e))
        if mode == "healed":
            # the healed convex combination admits only non-negative
            # weights: an expert less confident than the prior must not
            # vote with a negative coefficient
            beta = torch.clamp_min(beta, 0.0)
    else:  # poe / bcm / gpoe: unit weights; gpoe's 1/E after the reduction
        beta = alive * torch.ones_like(var_e)
    return (torch.sum(beta * prec_e, dim=0), torch.sum(beta * prec_e * mean_e, dim=0),
            torch.sum(beta, dim=0), n_alive)


def _aggregate(mode, sums, k_ss):
    prec_sum, wmean_sum, beta_sum, n_alive = sums
    if mode == "poe":
        prior_w = 0.0
    elif mode == "gpoe":
        prec_sum = prec_sum / n_alive
        wmean_sum = wmean_sum / n_alive
        prior_w = 0.0
    elif mode == "bcm":
        prior_w = 1.0 - n_alive
    elif mode == "healed":
        # test points where every expert reverted to the prior
        # (beta_sum == 0) take the prior moments exactly
        safe = torch.clamp_min(beta_sum, torch.finfo(k_ss.dtype).tiny)
        informed = beta_sum > 0
        prec = torch.where(informed, prec_sum / safe, 1.0 / k_ss)
        wmean = torch.where(informed, wmean_sum / safe, torch.zeros_like(wmean_sum))
        return wmean / prec, 1.0 / prec
    else:  # rbcm
        prior_w = 1.0 - beta_sum
    prec = prec_sum + prior_w / k_ss
    return wmean_sum / prec, 1.0 / prec


class PoEPredictor:
    """Fitted product-of-experts predictor at fixed hyperparameters: the
    expert stack and its per-expert factors (O(E s^2) memory), on the
    stack's device."""

    # per-chunk element budget for the [E, s, t_chunk] cross-kernel and
    # solve intermediates: bounded memory at any test-set size
    _PREDICT_CHUNK_ELEMS = 4_000_000

    def __init__(self, kernel: Kernel, theta, data: ExpertData, mode=None, mesh=None):
        if mode is None:
            from spark_gp_tpu_torch.models.aggregation import resolve_predictor_mode

            mode = resolve_predictor_mode(None, default="rbcm")
        if mode not in _MODES:
            raise ValueError(f"unknown PoE mode {mode!r}; expected one of {_MODES}")
        self.kernel = kernel
        self.theta = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=data.x.dtype,
                                     device=data.x.device)
        self.data = data
        self.mode = mode
        #: with a mesh, ``data`` is this rank's block and every prediction
        #: sums the ranks' expert reductions (one all-reduce a test chunk)
        self.mesh = mesh
        with torch.no_grad():
            kmat = masked_gram_stack(kernel, self.theta, data.x, data.mask)
            self._chol = cholesky(kmat)
            if not is_pd(self._chol):
                # a borderline expert gram climbs the jitter ladder matrix by
                # matrix (healthy experts keep their unjittered factors); a
                # stack the ladder cannot repair raises
                # NotPositiveDefiniteException
                self._chol, _ = cholesky_escalated(kmat, "per-expert Gram (PoE)",
                                                   schedule=JITTER_SCHEDULE)
            self._alpha = chol_solve(self._chol, data.y * data.mask)

    def predict(self, x_test) -> np.ndarray:
        return self.predict_with_var(x_test)[0]

    def predict_with_var(self, x_test):
        """``(mean [t], var [t])`` as float64 numpy; the test set streams in
        chunks of ``_PREDICT_CHUNK_ELEMS // (E s)`` points, the last one
        padded with copies of its first point."""
        x_test = torch.as_tensor(np.asarray(x_test, dtype=np.float64), dtype=self.data.x.dtype,
                                 device=self.data.x.device)
        t = x_test.shape[0]
        # every rank streams the same chunks (its block has the same shape)
        world = 1 if self.mesh is None else self.mesh.world_size
        rows = max(1, self.data.num_experts * world * self.data.expert_size)
        chunk = max(1, self._PREDICT_CHUNK_ELEMS // rows)
        means, vars_ = [], []
        with torch.no_grad():
            for start in range(0, t, chunk):
                part = x_test[start:start + chunk]
                n = part.shape[0]
                if n < chunk and t > chunk:
                    part = torch.cat([part, part[:1].expand(chunk - n, part.shape[1])])
                mean, var = self._predict_block(part)
                means.append(mean[:n])
                vars_.append(var[:n])
        return (torch.cat(means).to(torch.float64).cpu().numpy(),
                torch.cat(vars_).to(torch.float64).cpu().numpy())

    def _predict_block(self, x_test):
        k_ss = self.kernel.self_diag(self.theta, x_test)
        sums = _local_moments(self.kernel, self.mode, self.theta, self.data.x, self.data.mask,
                              self._chol, self._alpha, x_test, k_ss)
        if self.mesh is not None:
            # the JAX package's sharded predict: the three [t] sums and the
            # alive count summed over the ranks in one collective
            t = k_ss.shape[0]
            flat = self.mesh.all_reduce(torch.cat([sums[0], sums[1], sums[2],
                                                   sums[3].reshape(1)]))
            sums = (flat[:t], flat[t:2 * t], flat[2 * t:3 * t], flat[3 * t])
        return _aggregate(self.mode, sums, k_ss)


def make_poe_predictor(kernel: Kernel, theta, x, y, dataset_size_for_expert: int, mode=None,
                       dtype=None, device=None, mesh=None) -> PoEPredictor:
    """Group, factor and wrap on ``device`` (``None`` means ``"cuda"``) in
    ``dtype`` (default: float32 on the card, float64 on the CPU).
    ``mode=None`` resolves the engaged aggregation policy, else ``rbcm``.
    With ``mesh`` (``parallel/mesh.py``; every rank passes the same rows)
    each rank factors and predicts from its own block of the experts
    (``shard_experts``), and the precisions and precision-weighted means
    are summed over the ranks (the JAX package's sharded PoE)."""
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    device = resolve_device(device)
    dtype = working_dtype(device) if dtype is None else dtype
    data = group_for_experts(x, y, dataset_size_for_expert, dtype=dtype, device=device)
    if mesh is not None:
        from spark_gp_tpu_torch.parallel.mesh import shard_experts

        data = shard_experts(data, mesh)
    return PoEPredictor(kernel, theta, data, mode=mode, mesh=mesh)
