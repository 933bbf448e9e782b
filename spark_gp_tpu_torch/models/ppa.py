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
  in float64, the Cholesky factors being the PD check under the jitter
  ladder of ``ops/linalg.py``: on the host (numpy / scipy) below
  ``_DEVICE_SOLVE_MIN_M`` active points, on the model's device from there
  on (:func:`magic_solve_device`, or over a mesh of several ranks the
  row-sharded :func:`sharded_magic_solve`, under the ``ppa`` degradation
  ladder, whose last rung is the host solve).
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

import logging

import numpy as np
import torch
from scipy.linalg import solve_triangular

from spark_gp_tpu_torch.kernels.base import Kernel, prepare_gram_cache
from spark_gp_tpu_torch.ops.linalg import (
    JITTER_SCHEDULE,
    NotPositiveDefiniteException,
    psd_safe_cholesky_np,
)
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


def kmn_stats_sharded(kernel: Kernel, mesh, theta, active, data: ExpertData):
    """``(U1, u2)`` over every rank's experts: this rank's block ``data``
    accumulates its own statistics (:func:`kmn_stats`, float64 when the
    fit passes float64), then one all-reduce each sums them; the active
    set and theta are replicated.  The magic solve that follows runs on
    every rank alike (``magic_solve``)."""
    u1, u2 = kmn_stats(kernel, theta, active, data)
    return mesh.all_reduce(u1), mesh.all_reduce(u2)


def make_sharded_kmn_stats(kernel: Kernel, mesh):
    """``(theta, active, data) -> (U1, u2)`` summed over ``mesh``'s ranks
    (:func:`kmn_stats_sharded`)."""
    return lambda theta, active, data: kmn_stats_sharded(kernel, mesh, theta, active, data)


def _chol_solve_np(chol_l, b):
    y = solve_triangular(chol_l, b, lower=True)
    return solve_triangular(chol_l, y, lower=True, trans=1)


#: from this many active points on, the O(m^3) magic solve runs on the
#: model's device (:func:`magic_solve_device`); below it on the host, where
#: it is milliseconds and needs no transfer (the JAX package's threshold)
_DEVICE_SOLVE_MIN_M = 2048


def magic_solve(kernel: Kernel, theta, active, u1, u2,
                with_variance: bool = True, device=None, mesh=None):
    """Float64 solve for ``(magicVector, magicMatrix)``; the matrix is
    ``None`` when ``with_variance`` is False.  Dispatches by m: the host
    solve (:func:`_host_magic_solve`) below :data:`_DEVICE_SOLVE_MIN_M`;
    from there, over a ``mesh`` of more than one rank, the row-sharded
    solve (:func:`sharded_magic_solve`, on the mesh's devices), else
    :func:`magic_solve_device` on ``device`` (``None``: ``cuda``), both
    under the ``ppa`` ladder (``resilience/fallback.run_ppa_solve_ladder``:
    an OOM or compile failure re-runs the solve on the host; over several
    ranks it takes no host rung, see there).  Raises
    ``NotPositiveDefiniteException`` when the jitter ladder is exhausted,
    on every path."""
    if np.asarray(active).shape[0] >= _DEVICE_SOLVE_MIN_M:
        from spark_gp_tpu_torch.resilience.fallback import run_ppa_solve_ladder

        if mesh is not None and mesh.world_size > 1:
            def device_attempt():
                return sharded_magic_solve(kernel, theta, active, u1, u2, mesh,
                                           with_variance=with_variance)
        else:
            def device_attempt():
                return magic_solve_device(kernel, theta, active, u1, u2, with_variance, device)
        return run_ppa_solve_ladder(
            device_attempt,
            lambda: _host_magic_solve(kernel, theta, active, u1, u2, with_variance),
            mesh=mesh,
        )
    return _host_magic_solve(kernel, theta, active, u1, u2, with_variance)


def _host64(a) -> np.ndarray:
    """``a`` (numpy, or a tensor on any device) as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


@torch.no_grad()
def _host_magic_solve(kernel: Kernel, theta, active, u1, u2, with_variance: bool = True):
    """The host float64 solve (numpy / scipy): the small-m path and the
    ``ppa`` ladder's last rung.  The operands may be numpy or tensors on
    any device."""
    theta64, active64 = torch.tensor(_host64(theta)), torch.tensor(_host64(active))
    kmm = kernel.gram(theta64, active64).numpy()
    sn2 = float(kernel.white_noise_var(theta64))
    u1, u2 = _host64(u1), _host64(u2)

    l_pd = psd_safe_cholesky_np(sn2 * kmm + u1, "sigma2*K_mm + Kmn*Knm")
    magic_vector = _chol_solve_np(l_pd, u2)
    if not with_variance:
        return magic_vector, None
    l_mm = psd_safe_cholesky_np(kmm, "K_mm")
    eye = np.eye(kmm.shape[0])
    magic_matrix = sn2 * _chol_solve_np(l_pd, eye) - _chol_solve_np(l_mm, eye)
    return magic_vector, magic_matrix


def _device_factor(mat: torch.Tensor, tau: float, name: str):
    """``(L, bad)``: one factorization attempt of ``0.5 (mat + mat^T) +
    tau * trace / m * I`` (``name`` says which matrix: ``"PD"`` or
    ``"K_mm"``), and a device flag that it failed."""
    m = mat.shape[-1]
    sym = 0.5 * (mat + mat.mT)
    eye = torch.eye(m, dtype=mat.dtype, device=mat.device)
    chol_l, info = torch.linalg.cholesky_ex(sym + (tau * torch.trace(sym) / m) * eye)
    bad = (info != 0) | ~torch.isfinite(torch.diagonal(chol_l)).all()
    return chol_l, bad


def _device_chol_solve(chol_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = torch.linalg.solve_triangular(chol_l, b, upper=False)
    return torch.linalg.solve_triangular(chol_l.mT, y, upper=True)


@torch.no_grad()
def magic_solve_device(kernel: Kernel, theta, active, u1, u2, with_variance: bool = True,
                       device=None):
    """The float64 magic solve on ``device`` (``None``: ``cuda``; a CPU
    model runs the same code on the CPU) for large active sets:
    ``torch.linalg.cholesky_ex`` of the symmetrized matrices under the
    trace-relative jitter schedule (``ops/linalg.JITTER_SCHEDULE``), driven
    from the host: each attempt factors the matrices still failing and its
    failure flags are read once on the host.  Each factor walks the
    schedule on its own, as the host solve's factors do, so the two solves
    agree where one factor needs jitter and the other none, and a
    mean-only solve (``with_variance=False``, which never factors K_mm)
    gives the full solve's magic vector.  The active set's gram cache is
    built once, before the schedule.  Takes ``u2 [m]`` or ``[m, C]``, as
    numpy or as tensors (the fit passes its statistics where it built
    them, so nothing crosses to the host and back before the solve);
    returns float64 numpy ``(magicVector, magicMatrix or None)``.  A staged
    fault at the ``ppa.magic_solve`` choke point (``resilience/chaos.py``)
    raises where an allocator failure on the ``[m, m]`` solve would."""
    from spark_gp_tpu_torch.resilience import chaos

    chaos.maybe_injected_failure("ppa.magic_solve")
    dev = resolve_device(device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float64)
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    theta_d, active_d, u1_d, u2_d = put(theta), put(active), put(u1), put(u2)
    cache = prepare_gram_cache(kernel, active_d)
    kmm = kernel.gram(theta_d, active_d) if cache is None else \
        kernel.gram_from_cache(theta_d, cache)
    sn2 = kernel.white_noise_var(theta_d)
    mats = {"PD": sn2 * kmm + u1_d}
    if with_variance:
        mats["K_mm"] = kmm
    factors, taus = {}, {}
    for tau in JITTER_SCHEDULE:
        attempt = {name: _device_factor(mat, tau, name)
                   for name, mat in mats.items() if name not in factors}
        bad = torch.stack([flag for _, flag in attempt.values()]).cpu().tolist()
        for (name, (chol_l, _)), failed in zip(attempt.items(), bad):
            if not failed:
                factors[name], taus[name] = chol_l, tau
        if len(factors) == len(mats):
            break
    else:
        raise NotPositiveDefiniteException()
    for name, tau in taus.items():
        if tau:
            logging.getLogger("spark_gp_tpu_torch").warning(
                "device magic solve: %s required relative jitter %.3e for positive "
                "definiteness", name, tau)
    rhs = u2_d if u2_d.ndim == 2 else u2_d[:, None]
    mv = _device_chol_solve(factors["PD"], rhs)
    mv = mv if u2_d.ndim == 2 else mv[:, 0]
    if not with_variance:
        return mv.cpu().numpy(), None
    eye = torch.eye(kmm.shape[0], dtype=kmm.dtype, device=dev)
    mm = sn2 * _device_chol_solve(factors["PD"], eye) - _device_chol_solve(factors["K_mm"], eye)
    return mv.cpu().numpy(), mm.cpu().numpy()


@torch.no_grad()
def sharded_magic_solve(kernel: Kernel, theta, active, u1, u2, mesh, block: int = 128,
                        with_variance: bool = True):
    """The magic solve with its ``[m, m]`` factorizations row-sharded over
    ``mesh`` (``ops/dist_linalg.py``), on the mesh's devices in float64:
    the same trace-relative jitter schedule as :func:`magic_solve_device`,
    each factor walking it on its own (the JAX package's sharded solve
    walks both factors together; the port's device and host solves do
    not, and this one gives their answers), the finite check of each
    attempt all-reduced, so every rank takes the same rung.  ``m`` is
    padded to a multiple of ``world * block`` with an identity block,
    sliced away after the solves.  ``u1`` / ``u2`` are the replicated
    statistics (:func:`kmn_stats_sharded`), ``u2`` ``[m]`` or ``[m, C]``;
    every rank returns the same float64 numpy ``(magicVector, magicMatrix
    or None)``.  A mean-only solve never factors ``K_mm``.  A staged fault
    at the ``ppa.magic_solve`` choke point raises on every rank before
    any collective."""
    from spark_gp_tpu_torch.ops import dist_linalg as dl
    from spark_gp_tpu_torch.resilience import chaos

    chaos.maybe_injected_failure("ppa.magic_solve")
    dev = mesh.device

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float64)
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    theta_d, active_d, u1_d, u2_d = put(theta), put(active), put(u1), put(u2)
    cache = prepare_gram_cache(kernel, active_d)
    kmm = kernel.gram(theta_d, active_d) if cache is None else \
        kernel.gram_from_cache(theta_d, cache)
    sn2 = kernel.white_noise_var(theta_d)
    m = kmm.shape[0]
    gran = mesh.world_size * block
    m_pad = -(-m // gran) * gran
    eye = torch.eye(m, dtype=kmm.dtype, device=dev)
    mats = {"PD": sn2 * kmm + u1_d}
    if with_variance:
        mats["K_mm"] = kmm
    mats = {name: 0.5 * (mat + mat.mT) for name, mat in mats.items()}
    factors, taus = {}, {}
    for tau in JITTER_SCHEDULE:
        attempt = {name: dl.sharded_cholesky(
                       mesh, dl.pad_spd(mat + (tau * torch.trace(mat) / m) * eye, m_pad), block)
                   for name, mat in mats.items() if name not in factors}
        for (name, chol_loc), ok in zip(attempt.items(), dl.all_finite(mesh, *attempt.values())):
            if ok:
                factors[name], taus[name] = chol_loc, tau
        if len(factors) == len(mats):
            break
    else:
        raise NotPositiveDefiniteException()
    for name, tau in taus.items():
        if tau:
            logging.getLogger("spark_gp_tpu_torch").warning(
                "sharded magic solve: %s required relative jitter %.3e for positive "
                "definiteness", name, tau)
    rhs = torch.cat([u2_d, u2_d.new_zeros((m_pad - m,) + tuple(u2_d.shape[1:]))])
    mv = dl.sharded_chol_solve(mesh, factors["PD"], rhs, block)[:m]
    if not with_variance:
        return mv.cpu().numpy(), None
    eye_pad = torch.eye(m_pad, m, dtype=kmm.dtype, device=dev)
    pd_inv = dl.sharded_chol_solve(mesh, factors["PD"], eye_pad, block)[:m]
    kmm_inv = dl.sharded_chol_solve(mesh, factors["K_mm"], eye_pad, block)[:m]
    return mv.cpu().numpy(), (sn2 * pd_inv - kmm_inv).cpu().numpy()


def _predict_chunk(predictor, theta, active, mv, mm, part):
    """One predict chunk: the metered entry function (``obs/cost.py``
    keys its cost by this function and the operands' signature)."""
    return predictor._predict_block(theta, active, mv, mm, part)


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
        then the magic solve (:func:`magic_solve`) at the same theta and active set.  The
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
        magic_vector, magic_matrix = magic_solve(
            self.kernel, self.theta, self.active, u1, u2,
            with_variance=self.magic_matrix is not None, device=device,
        )
        u1, u2 = u1.cpu().numpy(), u2.cpu().numpy()
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
            # also arms the calibration loop: the metered peak of this
            # chunk's dispatch judges the model (obs/cost.py)
            raw = memplan.predict_dispatch_bytes(rows, m, p, itemsize, mm is None)
            memplan.note_expected_dispatch(memplan.predict_model_key(mm is None), raw)
            return raw

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
        from spark_gp_tpu_torch.obs import cost as obs_cost
        from spark_gp_tpu_torch.resilience import chaos

        t = x_test.shape[0]
        if t <= chunk:
            chaos.maybe_injected_failure("predict.chunk", rows=t, nbytes=dispatch_bytes(t))
            # metered flops and bytes per chunk (obs/cost.py, GP_XLA_COST)
            return obs_cost.observed_call("predict.ppa", _predict_chunk, self,
                                          theta, active, mv, mm, x_test)
        means, vars_ = [], []
        for start in range(0, t, chunk):
            part = x_test[start:start + chunk]
            pad = chunk - part.shape[0]
            if pad:
                part = torch.cat([part, part[:1].expand(pad, part.shape[1])])
            chaos.maybe_injected_failure("predict.chunk", rows=chunk, nbytes=dispatch_bytes(chunk))
            mean, var = obs_cost.observed_call("predict.ppa", _predict_chunk, self,
                                               theta, active, mv, mm, part)
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
