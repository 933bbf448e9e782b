"""Estimator plumbing: the parameter setters and the training skeleton.

Setter names and defaults are the JAX package's (and the reference's).
The port adds ``setDevice``: entry points run on ``cuda`` unless the
caller asks for ``cpu`` (``utils/device.py``).  Setters for what this
slice does not port raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from spark_gp_tpu_torch.kernels.base import (
    Const,
    EyeKernel,
    Kernel,
    ThetaOverrideKernel,
    masked_gram_stack,
    prepare_gram_cache,
    supports_matfree,
)
from spark_gp_tpu_torch.models import ppa
from spark_gp_tpu_torch.models.likelihood import masked_matfree_operator
from spark_gp_tpu_torch.models.active_set import (
    ActiveSetProvider,
    GreedilyOptimizingActiveSetProvider,
    KMeansActiveSetProvider,
    RandomActiveSetProvider,
)
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops.streamed_matvec import matvec_tiles
from spark_gp_tpu_torch.optimize.lbfgsb import (
    OptimizeResult,
    log_space_applicable,
    minimize_lbfgsb,
)
from spark_gp_tpu_torch.parallel.experts import ExpertData, group_for_experts
from spark_gp_tpu_torch.utils.device import working_dtype


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md queue 1, item {item})"
    )


class GaussianProcessParams:
    """Fluent parameter mixin with the JAX package's defaults."""

    def __init__(self, device=None) -> None:
        self._kernel_factory: Callable[[], Kernel] = _default_kernel_factory
        self._dataset_size_for_expert: int = 100
        self._active_set_size: int = 100
        self._sigma2: float = 1e-3
        self._active_set_provider: ActiveSetProvider = RandomActiveSetProvider
        self._max_iter: int = 100
        self._tol: float = 1e-6
        self._seed: int = 0
        self._hyper_space: str = "auto"
        self._num_restarts: int = 1
        self._restart_scale: float = 0.5
        self._predictive_variance: bool = True
        self._device = device

    def setKernel(self, value: Union[Kernel, Callable[[], Kernel]]):
        """A kernel factory (zero-arg callable) or a kernel spec."""
        if isinstance(value, Kernel):
            self._kernel_factory = lambda: value
        else:
            self._kernel_factory = value
        return self

    def setDatasetSizeForExpert(self, value: int):
        self._dataset_size_for_expert = int(value)
        return self

    def setActiveSetSize(self, value: int):
        self._active_set_size = int(value)
        return self

    def setSigma2(self, value: float):
        self._sigma2 = float(value)
        return self

    def setActiveSetProvider(self, value: ActiveSetProvider):
        self._active_set_provider = value
        return self

    def setMaxIter(self, value: int):
        self._max_iter = int(value)
        return self

    def setTol(self, value: float):
        self._tol = float(value)
        return self

    def setSeed(self, value: int):
        self._seed = int(value)
        return self

    def setAggregationDepth(self, value: int):
        """Accepted for API parity; the reduction topology is not a knob."""
        if int(value) < 1:
            raise ValueError("aggregation depth must be >= 1")
        return self

    def setPredictiveVariance(self, value: bool):
        """``False``: mean-only model (skips the two O(m^3) inverse builds
        of the magic matrix)."""
        self._predictive_variance = bool(value)
        return self

    def setHyperSpace(self, value: str):
        """``"log"``, ``"linear"`` or ``"auto"`` (log when applicable)."""
        if value not in ("auto", "log", "linear"):
            raise ValueError("hyper space must be 'auto', 'log' or 'linear'")
        self._hyper_space = value
        return self

    def setDevice(self, value):
        """``"cuda"`` (the default, also for ``None``), ``"cpu"``, or a
        ``torch.device``."""
        self._device = value
        return self

    def setOptimizer(self, value: str):
        """``"host"`` (SciPy L-BFGS-B) or ``"auto"``, which is ``"host"``."""
        if value not in ("auto", "host", "device"):
            raise ValueError("optimizer must be 'auto', 'host' or 'device'")
        if value == "device":
            raise _not_ported("the on-device optimizer", 4)
        return self

    #: whether the estimator's fit runs the multi-start driver
    _restarts_ported = False

    def setNumRestarts(self, value: int, scale: float = 0.5):
        """Multi-start hyperparameter optimization: ``value`` > 1 runs
        L-BFGS-B from the kernel's initial theta and from ``value - 1``
        seeded perturbations of it (``scale`` wide; log-normal in the log
        hyper space, else relative-scale normal, clipped to the bounds),
        one after another on the host, and keeps the lowest final
        objective (:meth:`GaussianProcessCommons._optimize_with_restarts`).
        Regression only; the classifiers' restarts and the batched device
        multi-start are ROADMAP.md queue 1, items 5 and 4."""
        if int(value) < 1:
            raise ValueError("number of restarts must be >= 1")
        if int(value) > 1 and not self._restarts_ported:
            raise _not_ported(f"multi-start fitting of {type(self).__name__}", 5)
        self._num_restarts = int(value)
        self._restart_scale = float(scale)
        return self

    def setMesh(self, mesh):
        if mesh is not None:
            raise _not_ported("sharding experts over several devices", 6)
        return self

    def setSolverLane(self, value: str):
        """Solver lane of the fit objective (``ops/iterative.py``):
        ``"exact"`` (the default: batched factorizations), ``"iterative"``
        (batched preconditioned CG + stochastic Lanczos quadrature on the
        materialized gram stack), ``"matfree"`` (the same solver with every
        gram product streamed, so the ``[E, s, s]`` stack is never built;
        kernels without the streaming protocol run ``"iterative"``) or
        ``"auto"`` (iterative from ``GP_SOLVER_AUTO_THRESHOLD`` rows per
        expert, default 1024).  A fluent veneer over the process-wide
        setting (``set_solver_lane`` / ``GP_SOLVER_LANE``): it applies to
        every later fit.  The engaged lane and the convergence report
        (``solver.*``) land in ``model.metrics``."""
        it_ops.set_solver_lane(value)
        return self

    def setCheckpointDir(self, path: Optional[str]):
        if path is not None:
            raise _not_ported("optimizer checkpointing", 7)
        return self

    def setCheckpointInterval(self, iters: int):
        """The device optimizer's checkpoint segment length: not ported."""
        if int(iters) < 1:
            raise ValueError("checkpoint interval must be >= 1")
        raise _not_ported("optimizer checkpointing", 7)

    def setProfileDir(self, path: Optional[str]):
        """``None`` (no trace), the only value the port takes."""
        if path is not None:
            raise _not_ported("profiler traces of a fit", 3)
        return self

    def setExpertQuarantine(self, value: bool):
        """``False``, the port's behaviour: a non-finite row raises
        ``ValueError`` before the fit."""
        if bool(value):
            raise _not_ported("expert quarantine", 2)
        return self

    def setFitRetries(self, value: int):
        """``0``, the port's behaviour: the first failure is final."""
        if int(value) < 0:
            raise ValueError("fit retries must be >= 0")
        if int(value) > 0:
            raise _not_ported("fit retries", 2)
        return self

    def setPrecisionLane(self, value: str):
        """``"strict"``, the port's only lane (``ops/precision.py``)."""
        if value not in ("strict", "mixed", "fast"):
            raise ValueError("precision lane must be 'strict', 'mixed' or 'fast'")
        if value != "strict":
            raise _not_ported(f"the {value!r} precision lane", 14)
        return self

    def setAggregationPolicy(self, value: str):
        """``"poe"``, the port's only policy (the plain product of
        experts)."""
        if value not in ("poe", "gpoe", "rbcm", "healed"):
            raise ValueError("aggregation policy must be 'poe', 'gpoe', 'rbcm' or 'healed'")
        if value != "poe":
            raise _not_ported(f"the {value!r} aggregation policy", 8)
        return self

    def _use_log_space(self, kernel) -> bool:
        if self._hyper_space == "linear":
            return False
        applicable = log_space_applicable(kernel.init_theta(), kernel.bounds()[0])
        if self._hyper_space == "log" and not applicable:
            raise ValueError(
                "log hyper space requires theta0 > 0 and lower bounds >= 0"
            )
        return applicable

    # snake_case aliases
    set_kernel = setKernel
    set_dataset_size_for_expert = setDatasetSizeForExpert
    set_active_set_size = setActiveSetSize
    set_sigma2 = setSigma2
    set_active_set_provider = setActiveSetProvider
    set_max_iter = setMaxIter
    set_tol = setTol
    set_seed = setSeed
    set_aggregation_depth = setAggregationDepth
    set_predictive_variance = setPredictiveVariance
    set_hyper_space = setHyperSpace
    set_device = setDevice
    set_optimizer = setOptimizer
    set_num_restarts = setNumRestarts
    set_mesh = setMesh
    set_solver_lane = setSolverLane
    set_checkpoint_dir = setCheckpointDir
    set_checkpoint_interval = setCheckpointInterval
    set_profile_dir = setProfileDir
    set_expert_quarantine = setExpertQuarantine
    set_fit_retries = setFitRetries
    set_precision_lane = setPrecisionLane
    set_aggregation_policy = setAggregationPolicy


def _default_kernel_factory() -> Kernel:
    from spark_gp_tpu_torch.kernels.rbf import RBFKernel

    return RBFKernel()


class GaussianProcessCommons(GaussianProcessParams):
    """Shared training skeleton: group -> optimize -> active set -> PPA."""

    #: the hyperparameter objective (regression's ``setObjective``)
    _objective = "marginal"
    #: whether the PPA model keeps U1 and u2 for ``update`` (regression)
    _keeps_update_statistics = False

    def _get_kernel(self) -> Kernel:
        """User kernel + sigma2 * I -- the noise-augmented model kernel."""
        return self._kernel_factory() + Const(self._sigma2) * EyeKernel()

    def _group(self, x: np.ndarray, y: np.ndarray, device) -> ExpertData:
        return group_for_experts(
            x, y, self._dataset_size_for_expert,
            dtype=working_dtype(device), device=device,
        )

    def _gram_cache(self, kernel: Kernel, data: ExpertData):
        """The fit's theta-invariant gram cache (``kernels/base.py``), built
        once on the stack's device in its dtype and handed to every
        objective evaluation; ``None`` when the kernel has no invariant
        (ARD, or a composite with such a child), when ``GP_GRAM_CACHE=0``,
        or when the fit runs the matfree lane with a kernel that streams:
        the cache is the ``[E, s, s]`` block that lane never builds.  The
        fits record the outcome as ``gram_cache_engaged``.  The ELBO
        objective takes none: its grams are cross kernels against the
        inducing set, which the self-distance cache does not cover."""
        if self._objective == "elbo":
            return None
        if supports_matfree(kernel) and it_ops.resolve_solver(data.expert_size) == "matfree":
            return None
        return prepare_gram_cache(kernel, data.x)

    def _optimize_hypers_body(
        self, kernel: Kernel, value_and_grad: Callable
    ) -> OptimizeResult:
        """Host L-BFGS-B from ``kernel.init_theta()`` within its bounds."""
        lower, upper = kernel.bounds()
        return minimize_lbfgsb(
            value_and_grad,
            kernel.init_theta(),
            lower,
            upper,
            max_iter=self._max_iter,
            tol=self._tol,
            log_space=self._use_log_space(kernel),
        )

    def _optimize_with_restarts(self, kernel: Kernel, value_and_grad: Callable):
        """The sequential multi-start driver (the JAX package's
        ``_fit_with_restarts``): L-BFGS-B from each row of
        :meth:`_restart_theta_batch` in turn, restart r through a
        :class:`ThetaOverrideKernel` of ``kernel``; the lowest finite final
        objective wins (the first on a tie).  Unlike the JAX driver the PPA
        model is built once, for the winner: it plays no part in the
        choice.  Returns ``(OptimizeResult, metrics)``, the metrics
        ``restart_{r}_nll``, ``num_restarts``, ``best_restart`` and
        ``restarts_nfev`` (the evaluations of every restart); empty for
        one restart.  Raises ``RuntimeError`` when no restart ends
        finite."""
        if self._num_restarts <= 1:
            return self._optimize_hypers_body(kernel, value_and_grad), {}
        results = [
            self._optimize_hypers_body(ThetaOverrideKernel(kernel, theta0), value_and_grad)
            for theta0 in self._restart_theta_batch(kernel)
        ]
        nlls = [res.fun if np.isfinite(res.fun) else np.inf for res in results]
        best = int(np.argmin(nlls))
        if not np.isfinite(nlls[best]):
            raise RuntimeError(
                "every restart produced a non-finite final NLL — the model "
                "configuration is numerically unusable at these settings"
            )
        metrics = {f"restart_{r}_nll": nll for r, nll in enumerate(nlls)}
        metrics.update(num_restarts=self._num_restarts, best_restart=best,
                       restarts_nfev=sum(res.nfev for res in results))
        return results[best], metrics

    def _restart_theta_batch(self, kernel: Kernel) -> np.ndarray:
        """``[R, h]`` starting points: row 0 is ``init_theta``, rows 1+
        seeded perturbations from numpy's ``default_rng(seed ^ 0x5EED5)``
        (log-normal in the log hyper space; else additive, scaled by
        ``|theta0|`` where nonzero and by the finite bound span otherwise),
        clipped to the bounds -- the JAX package's points, bit for bit."""
        theta0 = kernel.init_theta()
        lower, upper = kernel.bounds()
        use_log = self._use_log_space(kernel)
        rng = np.random.default_rng(self._seed ^ 0x5EED5)
        span = np.where(np.isfinite(upper - lower) & (upper > lower), upper - lower, 1.0)
        lin_scale = np.where(np.abs(theta0) > 0.0, np.abs(theta0), span)
        rows = [theta0]
        for _ in range(1, self._num_restarts):
            eps = self._restart_scale * rng.standard_normal(theta0.shape)
            if use_log:
                t_r = np.exp(np.log(theta0) + eps)
            else:
                t_r = theta0 + eps * lin_scale
            rows.append(np.clip(t_r, lower, upper))
        return np.stack(rows)

    def _optimize_latent_host(self, kernel: Kernel, objective: Callable, f0):
        """Host L-BFGS-B over a latent-carrying objective ``(theta, f0) ->
        (value, grad, f_new)``: every evaluation, line-search trials
        included, starts from the latent modes the previous one left
        (the reference mutates them in place, GPClf.scala:53-60), and one
        last evaluation at theta* settles them (GPClf.scala:60).  Returns
        ``(OptimizeResult, f_final)``."""
        state = {"f": f0}

        def value_and_grad(theta):
            value, grad, state["f"] = objective(theta, state["f"])
            return value, grad

        res = self._optimize_hypers_body(kernel, value_and_grad)
        _, _, f_final = objective(res.theta, state["f"])
        return res, f_final

    def _select_active(self, kernel, theta, x, y, device) -> np.ndarray:
        """The configured provider's ``[m, p]`` rows; the k-means and
        greedy providers run on the fit's ``device``."""
        provider = self._active_set_provider
        on_device = (KMeansActiveSetProvider, GreedilyOptimizingActiveSetProvider)
        kw = {"device": device} if isinstance(provider, on_device) else {}
        if getattr(provider, "uses_fit_outputs", True):
            active = provider(
                self._active_set_size, x, y, kernel, theta, self._seed, **kw
            )
        else:
            active = provider(
                self._active_set_size, x, None, kernel, None, self._seed, **kw
            )
        return np.asarray(active)

    def _projected_process(
        self, kernel: Kernel, theta_opt: np.ndarray, x: np.ndarray,
        y: np.ndarray, data: ExpertData, active: Optional[np.ndarray] = None,
    ) -> ppa.ProjectedProcessRawPredictor:
        """Active set -> (U1, u2) in float64 on the fit's device -> magic
        solve -> predictor.  ``active`` is a set selected before the
        optimization (the ELBO's), else the provider selects one at
        ``theta_opt``.  The statistics run in float64 because the normal
        equations square the conditioning (sigma2 as small as 1e-4)."""
        device = data.x.device
        if active is None:
            active = self._select_active(kernel, theta_opt, x, y, device)
        f64 = torch.float64
        data64 = ExpertData(
            x=data.x.to(f64), y=data.y.to(f64), mask=data.mask.to(f64)
        )
        u1, u2 = ppa.kmn_stats(
            kernel,
            torch.as_tensor(np.asarray(theta_opt, dtype=np.float64), device=device),
            torch.as_tensor(np.asarray(active, dtype=np.float64), device=device),
            data64,
        )
        return self._build_predictor(
            kernel, theta_opt, active, u1.cpu().numpy(), u2.cpu().numpy(), device
        )

    def _build_predictor(
        self, kernel: Kernel, theta, active, u1, u2, device
    ) -> ppa.ProjectedProcessRawPredictor:
        active64 = np.asarray(active, dtype=np.float64)
        magic_vector, magic_matrix = ppa.magic_solve(
            kernel, theta, active64, u1, u2,
            with_variance=self._predictive_variance,
        )
        return ppa.ProjectedProcessRawPredictor(
            kernel=kernel,
            theta=np.asarray(theta, dtype=np.float64),
            active=active64,
            magic_vector=magic_vector,
            magic_matrix=magic_matrix,
            # kept only where they sum over the raw targets (regression),
            # so that model.update() can fold new rows in; the Laplace
            # families' statistics sum over latent targets
            u1=np.asarray(u1, dtype=np.float64) if self._keeps_update_statistics else None,
            u2=np.asarray(u2, dtype=np.float64) if self._keeps_update_statistics else None,
            device=str(device),
        )

    def _emit_solver_stats(self, metrics: dict, kernel: Kernel, theta,
                           data: ExpertData) -> None:
        """The solver lane's fit-time record, into ``metrics``.

        Always stamps the engaged lane (``solver_lane``).  On the iterative
        and matfree lanes it also runs one forward pass of the solver at
        the fitted theta over the first (at most) 8 experts and records
        ``solver.cg_iters``, ``solver.precond_rank``, ``solver.probes`` and
        ``solver.residual``.  A matfree fit's pass runs the streamed
        operator the fit ran -- never a materialized stand-in -- and adds
        ``solver.matfree_engaged`` and ``solver.matvec_tiles``."""
        resolved = it_ops.resolve_solver(data.expert_size)
        metrics["solver_lane"] = resolved
        if resolved not in ("iterative", "matfree"):
            return
        probe = min(8, data.num_experts)
        x_p, mask_p = data.x[:probe], data.mask[:probe]
        y_p = data.y[:probe] * mask_p
        theta_p = torch.as_tensor(
            np.asarray(theta, dtype=np.float64), dtype=data.x.dtype, device=data.x.device
        )
        with torch.no_grad():
            if resolved == "matfree" and supports_matfree(kernel):
                _, mv_sg, diag_sg, col_sg = masked_matfree_operator(
                    kernel, theta_p, x_p, mask_p
                )
                report = it_ops.solver_report(
                    None, y_p, matvec=mv_sg, diag=diag_sg, col_fn=col_sg
                )
                metrics["solver.matfree_engaged"] = 1.0
                metrics["solver.matvec_tiles"] = float(matvec_tiles(data.expert_size))
            else:
                report = it_ops.solver_report(
                    masked_gram_stack(kernel, theta_p, x_p, mask_p), y_p
                )
                if resolved == "matfree":
                    # matfree asked, but the kernel cannot stream: the fit
                    # ran the materialized iterative lane
                    metrics["solver.matfree_engaged"] = 0.0
        for key in ("cg_iters", "precond_rank", "probes", "residual"):
            metrics[f"solver.{key}"] = float(report[key])
