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
  ``var = k(x, x) + k(x, A) magicMatrix k(x, A)^T``, the cross kernel and
  its contractions in float64, returned in the working dtype, in chunks
  that cap the ``[t, m]`` cross kernel; the joint covariance
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

# Cap on the [m, chunk] cross-kernel intermediate (elements): 4M f64
# entries = 32 MB.  The statistics hold ~3 such buffers at once (the
# distances, the kernel, its masked copy): at m = 1000 a 36,585-row chunk
# would hold ~3 x 293 MB, more than the float32 gram stack a matfree fit
# exists to avoid, so the PPA build could OOM where the fit did not.
_STATS_CHUNK_ELEMS = 4 * 1024 * 1024


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

    # cap on the [t, m] cross-kernel intermediate per chunk: 8M entries
    # (its float64 copy for the contractions is 64 MB)
    _PREDICT_CHUNK_ELEMS = 8 * 1024 * 1024

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
        ``K(x, x) + k(x, A) magicMatrix k(x, A)^T``, symmetrized, with the
        cross kernel and its contractions in float64 as in the predict
        (:meth:`_predict_block`); its diagonal is ``predict``'s variance up
        to rounding.  Not chunked: the result is ``O(t^2)``."""
        if self.magic_matrix is None:
            raise ValueError(
                "model was fitted with setPredictiveVariance(False); "
                "no covariance operator is available"
            )
        x_test, put = self._inputs(x_test)
        theta = put(self.theta)
        f64 = torch.float64

        def put64(a):
            return torch.as_tensor(np.asarray(a), dtype=f64, device=x_test.device)

        with torch.no_grad():
            cross = self.kernel.cross(put64(self.theta), x_test.to(f64), put64(self.active))
            mean = (cross @ put64(self.magic_vector)).to(x_test.dtype)
            quad = (cross @ put64(self.magic_matrix) @ cross.T).to(x_test.dtype)
            cov = self.kernel.gram(theta, x_test) + quad
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
        """The chunked predict under the predict ladder
        (``resilience/fallback.run_predict_ladder``): the chunk is sized
        by the memory plan where a budget resolves (``memplan.plan_predict_chunk``),
        an OOM on a chunk halves it and re-runs the request, and a chunk
        that cannot get under the ceiling falls to :meth:`_rowwise_f64_predict`
        on the same device."""
        from spark_gp_tpu_torch.resilience import memplan
        from spark_gp_tpu_torch.resilience.fallback import run_predict_ladder

        x_test, put = self._inputs(x_test)
        theta, active = put(self.theta), put(self.active)

        def put64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=x_test.device)

        mv = put64(self.magic_vector)
        mm = None if mean_only else put64(self.magic_matrix)
        t = x_test.shape[0]
        if t == 0:
            return (x_test.new_zeros((0,) + mv.shape[1:]),
                    None if mm is None else x_test.new_zeros((0,)))
        m, p = max(1, active.shape[0]), active.shape[1]
        itemsize = 8  # the cross kernel and its contractions are float64
        # clamped to the request, so the ladder's halvings walk down from
        # the size that actually ran
        chunk = max(1, min(self._PREDICT_CHUNK_ELEMS // m, t))
        planned = memplan.plan_predict_chunk(chunk, m, p, itemsize, mm is None)
        if planned is not None:
            chunk = planned

        def dispatch_bytes(rows: int) -> float:
            return memplan.predict_dispatch_bytes(rows, m, p, itemsize, mm is None)

        return run_predict_ladder(
            lambda c: self._run_at_chunk(x_test, theta, active, mv, mm, c, dispatch_bytes),
            lambda: self._rowwise_f64_predict(x_test, mean_only),
            chunk,
            planned=planned is not None,
        )

    def _predict_block(self, theta, active, mv, mm, part):
        """``(mean, var)`` of one chunk, returned in ``part``'s dtype: the
        cross kernel and its contractions with the magic vector and matrix
        in float64 (``mv``, ``mm`` are float64; ``theta``, ``active`` and
        ``part`` are upcast).  Both sums cancel heavily, so a row's
        prediction carries the cross kernel's rounding amplified; in
        float32 that rounding depends on the matrix-product kernel the
        library picks for the chunk's row count (on the card, bucket rows
        against a 4000-row chunk moved the airfoil mean by 7.0e-5 of its
        largest value).  In float64 a row's prediction does not depend on
        the chunk it was computed in."""
        f64 = torch.float64
        cross = self.kernel.cross(theta.to(f64), part.to(f64), active.to(f64))  # [c, m]
        mean = (cross @ mv).to(part.dtype)
        if mm is None:
            return mean, None
        quad = torch.einsum("tm,mk,tk->t", cross, mm, cross).to(part.dtype)
        return mean, self.kernel.self_diag(theta, part) + quad

    def _run_at_chunk(self, x_test, theta, active, mv, mm, chunk: int, dispatch_bytes):
        """The predict in chunks of ``chunk`` rows, every chunk of that one
        shape (the last padded with copies of its first row), each behind
        the ``predict.chunk`` fault-injection point."""
        from spark_gp_tpu_torch.resilience import chaos

        t = x_test.shape[0]
        if t <= chunk:
            chaos.maybe_injected_failure("predict.chunk", rows=t, nbytes=dispatch_bytes(t))
            return self._predict_block(theta, active, mv, mm, x_test)
        means, vars_ = [], []
        for start in range(0, t, chunk):
            part = x_test[start:start + chunk]
            pad = chunk - part.shape[0]
            if pad:
                part = torch.cat([part, part[:1].expand(pad, part.shape[1])])
            chaos.maybe_injected_failure("predict.chunk", rows=chunk, nbytes=dispatch_bytes(chunk))
            mean, var = self._predict_block(theta, active, mv, mm, part)
            means.append(mean[:chunk - pad])
            if var is not None:
                vars_.append(var[:chunk - pad])
        return torch.cat(means), torch.cat(vars_) if vars_ else None

    def _rowwise_f64_predict(self, x_test, mean_only: bool):
        """The predict ladder's last rung (``host_solve`` in the ladder's
        names): the request one row at a time, in float64, on
        ``x_test``'s own device -- the smallest dispatch there is, at the
        most precision -- returned in ``x_test``'s dtype.  It runs outside
        the ``predict.chunk`` fault-injection point."""
        f64 = torch.float64

        def put64(a):
            return torch.as_tensor(np.asarray(a), dtype=f64, device=x_test.device)

        theta, active, mv = put64(self.theta), put64(self.active), put64(self.magic_vector)
        mm = None if mean_only else put64(self.magic_matrix)
        x64 = x_test.to(f64)
        means, vars_ = [], []
        for row in range(x64.shape[0]):
            mean, var = self._predict_block(theta, active, mv, mm, x64[row:row + 1])
            means.append(mean)
            if var is not None:
                vars_.append(var)
        mean = torch.cat(means).to(x_test.dtype)
        return mean, torch.cat(vars_).to(x_test.dtype) if vars_ else None
