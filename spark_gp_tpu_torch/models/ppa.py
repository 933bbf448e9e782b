"""Projected Process Approximation: the statistics, the "magic" solve and
the predictor (R&W ch. 8.3.4).

* Statistics -- against the m-point active set A, over all experts'
  points:  ``U1 = sum K_mn K_nm`` and ``u2 = sum K_mn y``, in float64 on
  the device, in chunks that cap the ``[m, chunk]`` cross kernel.  ``y``
  is ``[E, s]`` (one target, ``u2 [m]``) or ``[E, s, C]`` (the multiclass
  classifier's C latent stacks, which share U1: ``u2 [m, C]``).
* Solve -- with ``sn2`` the total white-noise variance of the fitted
  noise-augmented kernel, ``PD = sn2 K_mm + U1``:
  ``magicVector = PD^-1 u2`` (``[m]`` or ``[m, C]``) and ``magicMatrix = sn2 PD^-1 - K_mm^-1``,
  in host float64 numpy/scipy (Cholesky factors are the PD check, under
  the jitter ladder of ``ops/linalg.py``).
* Predict -- ``mean = k(x, A) magicVector`` (``[t]`` or ``[t, C]``) and
  ``var = k(x, x) + k(x, A) magicMatrix k(x, A)^T``, in the working dtype,
  in chunks that cap the ``[t, m]`` cross kernel; the joint covariance
  ``K(x, x) + k(x, A) magicMatrix k(x, A)^T`` (``predict_with_cov``).
* Update -- the statistics are sums over points, so new rows fold in as
  ``U1 += C C^T``, ``u2 += C y`` with ``C = K(A, x_new)``, then one magic
  solve at the same theta and active set (``with_additional_data``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy.linalg import solve_triangular

from spark_gp_tpu_torch.kernels.base import Kernel
from spark_gp_tpu_torch.ops.linalg import psd_safe_cholesky_np
from spark_gp_tpu_torch.parallel.experts import ExpertData
from spark_gp_tpu_torch.utils.device import resolve_device, working_dtype

# Cap on the [m, chunk] cross-kernel intermediate (elements): 64M f64
# entries = 512 MB.
_STATS_CHUNK_ELEMS = 64 * 1024 * 1024


def _flat_stats(kernel: Kernel, theta, active, xf, yf, maskf):
    """``(K_mn K_nm, K_mn y)`` over a flat ``[c, p]`` chunk of points;
    ``yf`` is ``[c]`` or ``[c, C]``."""
    kmn = kernel.cross(theta, active, xf) * maskf[None, :]  # [m, c]
    return kmn @ kmn.T, kmn @ (yf * (maskf if yf.ndim == 1 else maskf[:, None]))


@torch.no_grad()
def kmn_stats(kernel: Kernel, theta, active, data: ExpertData):
    """``(U1 [m, m], u2 [m] or [m, C])`` accumulated over every expert's
    points, in the dtype and on the device of its inputs (the fit passes
    float64); ``data.y`` is ``[E, s]`` or ``[E, s, C]``."""
    e, s, p = data.x.shape
    xf = data.x.reshape(e * s, p)
    yf = data.y.reshape((e * s,) + tuple(data.y.shape[2:]))
    maskf = data.mask.reshape(e * s)
    n_flat = e * s
    chunk = max(1, min(n_flat, _STATS_CHUNK_ELEMS // max(active.shape[0], 1)))
    u1 = u2 = None
    for start in range(0, n_flat, chunk):
        stop = start + chunk
        du1, du2 = _flat_stats(
            kernel, theta, active, xf[start:stop], yf[start:stop],
            maskf[start:stop],
        )
        u1, u2 = (du1, du2) if u1 is None else (u1 + du1, u2 + du2)
    return u1, u2


def _chol_solve_np(chol_l, b):
    y = solve_triangular(chol_l, b, lower=True)
    return solve_triangular(chol_l, y, lower=True, trans=1)


@torch.no_grad()
def magic_solve(kernel: Kernel, theta, active, u1, u2,
                with_variance: bool = True):
    """Host float64 solve for ``(magicVector, magicMatrix)``; the matrix is
    ``None`` when ``with_variance`` is False.  Raises
    ``NotPositiveDefiniteException`` when the jitter ladder is exhausted."""
    theta64 = torch.as_tensor(np.asarray(theta, dtype=np.float64))
    active64 = torch.as_tensor(np.asarray(active, dtype=np.float64))
    kmm = kernel.gram(theta64, active64).numpy()
    sn2 = float(kernel.white_noise_var(theta64))
    u1 = np.asarray(u1, dtype=np.float64)
    u2 = np.asarray(u2, dtype=np.float64)

    l_pd = psd_safe_cholesky_np(sn2 * kmm + u1, "sigma2*K_mm + Kmn*Knm")
    magic_vector = _chol_solve_np(l_pd, u2)
    if not with_variance:
        return magic_vector, None
    l_mm = psd_safe_cholesky_np(kmm, "K_mm")
    eye = np.eye(kmm.shape[0])
    magic_matrix = sn2 * _chol_solve_np(l_pd, eye) - _chol_solve_np(l_mm, eye)
    return magic_vector, magic_matrix


@dataclass
class ProjectedProcessRawPredictor:
    """``(mean, variance)`` predictor against the m-point model.

    Model: ``theta [h]``, ``active [m, p]``, ``magic_vector [m]`` (or
    ``[m, C]``: C latent means sharing the variance),
    ``magic_matrix [m, m]`` (``None`` for a mean-only model), and the
    additive statistics ``u1``/``u2`` behind the solve.  Predictions run on
    ``device`` (``None`` means ``cuda``) in its working dtype."""

    kernel: Kernel
    theta: np.ndarray
    active: np.ndarray
    magic_vector: np.ndarray
    magic_matrix: Optional[np.ndarray]
    u1: Optional[np.ndarray] = None
    u2: Optional[np.ndarray] = None
    device: Optional[str] = None

    # cap on the [t, m] cross-kernel intermediate per chunk: 32M entries
    _PREDICT_CHUNK_ELEMS = 32 * 1024 * 1024

    def with_additional_data(self, x_new, y_new) -> "ProjectedProcessRawPredictor":
        """A new predictor with ``(x_new, y_new)`` folded into the
        statistics (``U1 += C C^T``, ``u2 += C y``, ``C = K(A, x_new)``,
        in float64 on the predictor's device, in chunks that cap ``C``),
        then the host magic solve at the same theta and active set.  The
        projected process with its inducing set and kernel held fixed:
        refit when the new rows may move the hyperparameters."""
        if self.u1 is None or self.u2 is None:
            raise ValueError(
                "this model does not carry updatable PPA statistics: only "
                "regression fits store them (the Laplace families' "
                "statistics are over latent targets — refit those; pre-r4 "
                "saves lack them — refit to enable incremental updates)"
            )
        x_new = np.asarray(x_new, dtype=np.float64)
        y_new = np.asarray(y_new, dtype=np.float64)
        if x_new.ndim != 2 or x_new.shape[1] != self.active.shape[1]:
            raise ValueError(
                f"x_new must be [t, {self.active.shape[1]}], got "
                f"{tuple(x_new.shape)}"
            )
        if y_new.shape != (x_new.shape[0],):
            raise ValueError(
                f"y_new must be [{x_new.shape[0]}], got {tuple(y_new.shape)}"
            )
        device = resolve_device(self.device)

        def put(a):
            return torch.tensor(np.asarray(a, dtype=np.float64), device=device)

        theta, active = put(self.theta), put(self.active)
        u1, u2 = put(self.u1), put(self.u2)
        xt, yt = put(x_new), put(y_new)
        chunk = max(1, self._PREDICT_CHUNK_ELEMS // max(1, active.shape[0]))
        with torch.no_grad():
            for start in range(0, xt.shape[0], chunk):
                cross = self.kernel.cross(theta, active, xt[start:start + chunk])  # [m, c]
                u1 = u1 + cross @ cross.T
                u2 = u2 + cross @ yt[start:start + chunk]
        u1, u2 = u1.cpu().numpy(), u2.cpu().numpy()
        magic_vector, magic_matrix = magic_solve(
            self.kernel, self.theta, self.active, u1, u2,
            with_variance=self.magic_matrix is not None,
        )
        return ProjectedProcessRawPredictor(
            kernel=self.kernel, theta=self.theta, active=self.active,
            magic_vector=magic_vector, magic_matrix=magic_matrix,
            u1=u1, u2=u2, device=self.device,
        )

    def predict_with_cov(self, x_test):
        """``(mean [t], cov [t, t])``: the joint predictive covariance
        ``K(x, x) + k(x, A) magicMatrix k(x, A)^T``, symmetrized; its
        diagonal is ``predict``'s variance up to rounding.  Not chunked:
        the result is ``O(t^2)``."""
        if self.magic_matrix is None:
            raise ValueError(
                "model was fitted with setPredictiveVariance(False); "
                "no covariance operator is available"
            )
        x_test, put = self._inputs(x_test)
        theta, active = put(self.theta), put(self.active)
        with torch.no_grad():
            cross = self.kernel.cross(theta, x_test, active)  # [t, m]
            mean = cross @ put(self.magic_vector)
            cov = self.kernel.gram(theta, x_test) + cross @ put(self.magic_matrix) @ cross.T
        return mean, 0.5 * (cov + cov.T)

    def predict_mean(self, x_test) -> torch.Tensor:
        """Mean-only prediction ``[t]`` or ``[t, C]`` (skips the O(t m^2)
        variance)."""
        return self._run(x_test, mean_only=True)[0]

    def __call__(self, x_test):
        """``(mean [t], var [t])``; ``var`` is None for mean-only models."""
        return self._run(x_test, mean_only=self.magic_matrix is None)

    def _inputs(self, x_test):
        """``x_test`` checked and on the predictor's device in its working
        dtype, with the function that puts the model's arrays there."""
        device = resolve_device(self.device)
        dtype = working_dtype(device)
        p = self.active.shape[1]
        x_test = torch.as_tensor(np.asarray(x_test), device=device).to(dtype)
        if x_test.ndim != 2 or x_test.shape[1] != p:
            raise ValueError(
                f"x_test must be [t, {p}] (the model was fitted on {p} "
                f"features); got shape {tuple(x_test.shape)}"
            )

        def put(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        return x_test, put

    @torch.no_grad()
    def _run(self, x_test, mean_only: bool):
        x_test, put = self._inputs(x_test)
        theta, active, mv = put(self.theta), put(self.active), put(self.magic_vector)
        mm = None if mean_only else put(self.magic_matrix)
        t = x_test.shape[0]
        chunk = max(1, min(self._PREDICT_CHUNK_ELEMS // max(1, active.shape[0]), t))
        means, vars_ = [], []
        for start in range(0, t, chunk):
            part = x_test[start:start + chunk]
            cross = self.kernel.cross(theta, part, active)  # [c, m]
            means.append(cross @ mv)
            if mm is not None:
                vars_.append(
                    self.kernel.self_diag(theta, part)
                    + torch.einsum("tm,mk,tk->t", cross, mm, cross)
                )
        mean = torch.cat(means) if means else x_test.new_zeros((0,) + mv.shape[1:])
        if mm is None:
            return mean, None
        return mean, torch.cat(vars_) if vars_ else x_test.new_zeros((0,))
