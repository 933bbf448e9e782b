"""Estimator plumbing: the parameter setters and the training skeleton.

Setter names and defaults are the JAX package's (and the reference's).
The port adds ``setDevice``: entry points run on ``cuda`` unless the
caller asks for ``cpu`` (``utils/device.py``).  Setters for what this
slice does not port raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.

Every fit runs inside the observability shell (:meth:`_observed_fit`:
the root span ``fit.<Family>``, the kernel and memory capture, the run
journal, an incident bundle on a terminal classified failure), around
the degradation ladder (``resilience/fallback.py``), around the per-expert
recovery (:meth:`_run_with_expert_resilience`).
"""

from __future__ import annotations

import contextlib
import warnings
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
from spark_gp_tpu_torch.models.active_set import (
    ActiveSetProvider,
    GreedilyOptimizingActiveSetProvider,
    KMeansActiveSetProvider,
    RandomActiveSetProvider,
)
from spark_gp_tpu_torch.models.likelihood import masked_matfree_operator
from spark_gp_tpu_torch.obs import trace as obs_trace
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops.streamed_matvec import matvec_tiles
from spark_gp_tpu_torch.optimize.lbfgsb import (
    OptimizeResult,
    log_space_applicable,
    minimize_lbfgsb,
)
from spark_gp_tpu_torch.parallel.experts import ExpertData, group_for_experts, num_experts_for
from spark_gp_tpu_torch.utils.device import working_dtype
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation, maybe_profile


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
        self._expert_quarantine: bool = True
        self._fit_retries: int = 2
        self._profile_dir: Optional[str] = None
        self._checkpoint_dir: Optional[str] = None
        #: the fitted stack's fingerprint while a checkpointed fit optimizes
        self._fit_data_key: Optional[list] = None
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
        """Persist the host optimizer's state for kill-and-resume: theta
        and the evaluation log are saved every L-BFGS-B iteration
        (``utils/checkpoint.LbfgsCheckpointer``), and a fit of the same
        kernel on the same data that finds its checkpoint in this
        directory resumes from it
        (:meth:`GaussianProcessCommons._optimize_hypers_body`).  ``None``
        (the default) saves nothing."""
        self._checkpoint_dir = None if path is None else str(path)
        return self

    def setCheckpointInterval(self, iters: int):
        """The device optimizer's segment length, iterations between its
        checkpoints: validated as in the JAX package, and without effect
        here, since the port has only the host optimizer, which saves every
        iteration (the device optimizer is ROADMAP.md queue 1, item 4), so
        it warns."""
        if int(iters) < 1:
            raise ValueError("checkpoint interval must be >= 1")
        warnings.warn(
            "setCheckpointInterval has no effect: it sets the on-device "
            "optimizer's segment length, which is not ported to PyTorch yet "
            "(ROADMAP.md queue 1, item 4); the host optimizer checkpoints "
            "every iteration",
            UserWarning,
            stacklevel=2,
        )
        return self

    def setProfileDir(self, path: Optional[str]):
        """Capture a ``torch.profiler`` trace (CPU and CUDA activities) of
        the fit's optimization and PPA build into this directory as a
        Chrome trace (``utils/instrumentation.maybe_profile``); ``None``
        (the default) captures nothing unless ``GP_TRACE_DIR`` names a
        directory."""
        self._profile_dir = None if path is None else str(path)
        return self

    def setExpertQuarantine(self, value: bool):
        """``True`` (default): experts carrying non-finite rows are dropped
        before the fit (the data screen), and experts whose NLL or
        gradient is non-finite during it are repaired by jitter escalation
        or dropped, with renormalization (``resilience/quarantine.py``).
        A failure of every expert still raises.  ``False``: any non-finite
        expert fails the fit."""
        self._expert_quarantine = bool(value)
        return self

    def setFitRetries(self, value: int):
        """How many times a failed fit attempt is retried (with backoff)
        after quarantine or jitter repair; default 2, 0 makes the first
        failure final."""
        if int(value) < 0:
            raise ValueError("fit retries must be >= 0")
        self._fit_retries = int(value)
        return self

    def setPrecisionLane(self, value: str):
        """``"strict"``, the port's only lane (``ops/precision.py``)."""
        if value not in ("strict", "mixed", "fast"):
            raise ValueError("precision lane must be 'strict', 'mixed' or 'fast'")
        if value != "strict":
            raise _not_ported(f"the {value!r} precision lane", 14)
        return self

    def setAggregationPolicy(self, value: str):
        """Expert-aggregation policy of the PoE predictor
        (``models/aggregation.py``): ``"poe"`` (the plain product of
        experts), ``"gpoe"``, ``"rbcm"`` or ``"healed"``.  A fluent veneer
        over the process-wide setting (``set_agg_policy`` /
        ``GP_AGG_POLICY``); fits stamp it as ``agg.policy``."""
        from spark_gp_tpu_torch.models.aggregation import set_agg_policy

        set_agg_policy(value)
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
    #: the degradation ladder's rung override while an attempt runs
    #: (``resilience/fallback._fit_rung_scope``)
    _fallback_mode: Optional[str] = None

    # --- the observability shell and the ladder's plumbing ---------------
    def _observed_fit(self, instr: Instrumentation, run):
        """The observability shell around one complete public fit: opens
        the root span ``fit.<name>`` every phase span nests under,
        activates the capture (kernel builds and launches, memory samples
        at phase boundaries), mints the fit's trace id, and stamps the
        returned model with its ``run_journal`` (``obs/runtime.py``).  A
        terminal classified failure escaping the fit dumps exactly one
        incident bundle (``obs/recorder.py``) before re-raising.  With
        tracing off (``GP_TRACING=0``) there are no spans, capture or
        journal, but the failure shell stays (the recorder has its own
        gate, ``GP_RECORDER``)."""
        from spark_gp_tpu_torch.obs import recorder as obs_recorder
        from spark_gp_tpu_torch.obs import runtime as obs_runtime

        entry = f"fit.{instr.name}"
        if not obs_trace.tracing_enabled():
            try:
                return run()
            except Exception as exc:  # classified-failure-site: bundle + re-raise
                obs_recorder.record_fit_failure(exc, entry=entry, instr=instr)
                raise
        token = obs_runtime.new_trace_token()
        with obs_runtime.trace_token_scope(token), obs_runtime.fit_capture(instr.name) as cap:
            root = None
            try:
                with obs_trace.span(entry, family=type(self).__name__, trace_token=token) as root:
                    model = run()
            except Exception as exc:  # classified-failure-site: bundle + re-raise
                obs_recorder.record_fit_failure(exc, entry=entry, instr=instr, root=root,
                                                capture=cap)
                raise
        model.run_journal = obs_runtime.write_run_journal(
            getattr(model, "instr", None) or instr, root, cap, trace_token=token)
        return model

    def _resolved_optimizer(self) -> str:
        """``"host"``: SciPy L-BFGS-B, the port's only optimizer (the
        on-device one is ROADMAP.md queue 1, item 4), on every rung."""
        return "host"

    def _host_f64_operands(self, data: ExpertData, extra=(), cache=None):
        """``(data, extra, cache)`` with the stack in float64 ON ITS DEVICE
        and no gram cache while the ladder's ``host_f64`` rung runs (the
        same fit with float64 operands, where K1's gate sends the stack to
        the batched Cholesky: ``ops/spd_linalg.kernel_applies``); the inputs
        untouched otherwise."""
        if self._fallback_mode != "host_f64":
            return data, extra, cache
        f64 = torch.float64
        data64 = ExpertData(x=data.x.to(f64), y=data.y.to(f64), mask=data.mask.to(f64))
        extra64 = tuple(e.to(f64) if isinstance(e, torch.Tensor) else e for e in extra)
        return data64, extra64, None

    def _dispatch_raw_bytes(self, data: ExpertData) -> float:
        """Modeled raw peak bytes of one objective evaluation of the fit
        about to run (``memplan.fit_dispatch_bytes`` at the resolved lane's
        rung, in the stack's dtype)."""
        from spark_gp_tpu_torch.resilience import memplan

        e, s, p = (int(d) for d in data.x.shape)
        rung = memplan.fit_rung_of_lane(it_ops.resolve_for(data),
                                        supports_matfree(self._get_kernel()))
        n_targets = int(data.y.shape[2]) if data.y.ndim == 3 else 1
        return memplan.fit_dispatch_bytes(e, s, p, data.x.element_size(), rung, n_targets,
                                          type(self).__name__)

    @contextlib.contextmanager
    def _optimize_phase(self, instr: Instrumentation, data: ExpertData):
        """The ``optimize_hypers`` phase around the host optimizer, opened
        by the ``fit.host`` fault-injection point.  Unlike the JAX
        package's, that point passes the resolved lane's modeled bytes, so
        a staged ``chaos.memory_limit_bytes`` acts on the host path: the
        port has no other.  Under ``setCheckpointDir`` it also takes the
        content fingerprint of the stack being fitted, which ties a
        checkpoint's evaluation log to its data (:meth:`_resume_payload`)."""
        from spark_gp_tpu_torch.resilience import chaos
        from spark_gp_tpu_torch.utils.checkpoint import data_fingerprint

        chaos.maybe_injected_failure("fit.host", nbytes=self._dispatch_raw_bytes(data))
        self._fit_data_key = None if self._checkpoint_dir is None else \
            data_fingerprint(data.x, data.y, data.mask)
        try:
            with instr.phase("optimize_hypers"):
                yield
        finally:
            self._fit_data_key = None

    def _attempt_operands(self, kernel: Kernel, data: ExpertData):
        """``(data, cache)`` of one latent-family fit attempt: the float64
        stack without a cache on the ``host_f64`` rung, else the stack with
        its gram cache (built inside the attempt, so a rung's lane decides
        whether it exists)."""
        if self._fallback_mode == "host_f64":
            return self._host_f64_operands(data)[0], None
        return data, self._gram_cache(kernel, data)

    @staticmethod
    def _phase_metrics(instr: Instrumentation) -> dict:
        """``group_seconds``, ``optimize_seconds`` and ``ppa_seconds`` from
        the phase timings (summed over the attempts of a recovered or
        degraded fit; ``ppa_seconds`` is active_set + kmn_stats +
        magic_solve)."""
        t = instr.timings
        return {
            "group_seconds": t.get("group_experts", 0.0),
            "optimize_seconds": t.get("optimize_hypers", 0.0),
            "ppa_seconds": sum(t.get(k, 0.0) for k in ("active_set", "kmn_stats", "magic_solve")),
        }

    def _get_kernel(self) -> Kernel:
        """User kernel + sigma2 * I -- the noise-augmented model kernel."""
        return self._kernel_factory() + Const(self._sigma2) * EyeKernel()

    def _group(self, x: np.ndarray, y: np.ndarray, device) -> ExpertData:
        return group_for_experts(
            x, y, self._dataset_size_for_expert,
            dtype=working_dtype(device), device=device,
        )

    def _group_screened(self, instr: Instrumentation, x, y, device) -> ExpertData:
        """Group, and the data screen: experts carrying a non-finite row
        are quarantined here, before the objective meets it.  Round-robin
        grouping puts row ``i`` in expert ``i % E``, so the bad experts
        follow from the bad rows in host numpy."""
        bad_experts = None
        if self._expert_quarantine:
            finite = self._finite_row_mask(x, y)
            if finite is not None:
                e = num_experts_for(x.shape[0], self._dataset_size_for_expert)
                bad_experts = np.zeros(e, dtype=bool)
                bad_experts[np.flatnonzero(~finite) % e] = True
        data = self._group(x, y, device)
        if bad_experts is not None:
            data = self._apply_quarantine(instr, data, bad_experts, "data screen")
        return data

    @staticmethod
    def _finite_row_mask(x, y=None):
        """bool [N] of the rows whose features (and labels, when given) are
        all finite, or ``None`` when every row is: the one test behind the
        data screen and the provider-row filters."""
        finite = np.all(np.isfinite(x), axis=1)
        if y is not None:
            finite &= np.all(np.isfinite(np.asarray(y).reshape(x.shape[0], -1)), axis=1)
        return None if finite.all() else finite

    def _screen_rows(self, x, y):
        """``(x, y)`` without their non-finite rows: the active-set
        providers sample the raw rows, and one NaN row in the active set
        would poison the PPA statistics that the quarantine cleaned."""
        if not self._expert_quarantine:
            return x, y
        finite = self._finite_row_mask(x, y)
        if finite is None:
            return x, y
        return x[finite], np.asarray(y)[finite]

    def _provider_rows_filter(self, x):
        """``(x_filtered, n_orig, row_filter)`` for the latent-target
        estimators: their providers sample the raw rows while their targets
        are per-point latents of the original length, so both are filtered
        by the same finite-row mask (``row_filter`` applies it to a
        ``[n_orig]`` vector)."""
        n_orig = x.shape[0]
        finite = self._finite_row_mask(x) if self._expert_quarantine else None
        if finite is None:
            return x, n_orig, (lambda t: t)
        return x[finite], n_orig, (lambda t: np.asarray(t)[finite])

    @staticmethod
    def _log_renormalized_nll(metrics: dict) -> None:
        """With experts quarantined or deselected, the full-stack-comparable
        objective ``final_nll_renormalized = final_nll * bcm_renorm *
        agg.renorm``; ``final_nll`` stays the optimizer's reduced sum."""
        renorm = metrics.get("bcm_renorm")
        agg_renorm = metrics.get("agg.renorm")
        if agg_renorm is not None and float(agg_renorm) != 1.0:
            renorm = (1.0 if renorm is None else renorm) * float(agg_renorm)
        if renorm is not None and "final_nll" in metrics:
            metrics["final_nll_renormalized"] = metrics["final_nll"] * renorm

    def _apply_quarantine(self, instr: Instrumentation, data: ExpertData, bad, source: str) -> ExpertData:
        """Make the ``bad`` experts inert and account for it:
        ``experts_active_initial`` is pinned at the first drop, so later
        rounds count against the original stack, and ``bcm_renorm`` maps
        the reduced sum back to a full-stack-comparable NLL."""
        from spark_gp_tpu_torch.models.aggregation import effective_expert_count
        from spark_gp_tpu_torch.resilience.quarantine import (
            GLOBAL_FAILURE_ADVICE,
            ExpertQuarantineError,
            quarantine_experts,
            renorm_factor,
        )

        bad = np.asarray(bad, dtype=bool)
        n_bad = int(bad.sum())
        if n_bad == 0:
            return data
        active = int((data.mask.sum(dim=1) > 0).sum())
        if n_bad >= active:
            raise ExpertQuarantineError(
                f"{source}: all {active} active expert(s) are non-finite — "
                + GLOBAL_FAILURE_ADVICE
            )
        data = quarantine_experts(data, bad)
        metrics = instr.metrics
        base = metrics.setdefault("experts_active_initial", float(active))
        dropped = metrics.get("experts_quarantined", 0.0) + n_bad
        metrics["experts_quarantined"] = dropped
        renorm = renorm_factor(base, dropped)
        metrics["bcm_renorm"] = renorm
        if instr.agg_weights is not None:
            # a quarantined expert's aggregation weight is exactly 0
            instr.agg_weights = np.where(bad, 0.0, instr.agg_weights)
            metrics["agg.effective_experts"] = effective_expert_count(instr.agg_weights)
        instr.log_warning(
            f"{source}: quarantined {n_bad} non-finite expert(s) "
            f"({int(dropped)}/{int(base)} total dropped); BCM objective "
            f"renormalized by {renorm:.4f}"
        )
        # the drop as a span event: the run journal shows WHEN it happened
        obs_trace.add_event("experts.quarantined", count=n_bad, source=source,
                            total_dropped=int(dropped))
        return data

    def _apply_expert_selection(self, instr: Instrumentation, data: ExpertData):
        """Fit-time expert selection (``models/aggregation.py``), before any
        objective evaluation: ``drop`` mode compacts the stack to the kept
        experts, ``downweight`` mode hands back fractional weights for the
        marginal objective.  Returns ``(data, extra)``, ``extra`` either
        ``()`` or the marginal objective's ``(None, weights)`` (slot 0 is
        the recovery loop's jitter).  Off unless ``GP_AGG_SELECT``."""
        from spark_gp_tpu_torch.models import aggregation as agg

        if not agg.selection_enabled():
            return data, ()
        mode = agg.selection_mode()
        if mode == "downweight" and self._objective != "marginal":
            # only the marginal objective takes the weights; masking works
            # for every objective
            instr.log_warning(
                "aggregation selection: downweight mode requires the "
                "marginal objective; falling back to drop semantics "
                f"for objective {self._objective!r}"
            )
            mode = "drop"
        report = agg.select_experts(data, mode=mode, seed=self._seed)
        weights = np.asarray(report.weights, dtype=np.float64)
        instr.agg_weights = weights
        instr.metrics["agg.selection_dropped"] = float(report.num_dropped)
        instr.metrics["agg.renorm"] = report.renorm
        instr.metrics["agg.effective_experts"] = agg.effective_expert_count(weights)
        if report.clean:
            return data, ()
        obs_trace.add_event("experts.deselected", dropped=report.num_dropped,
                            mode=report.mode, threshold=report.threshold)
        if report.mode == "downweight":
            instr.log_warning(
                "aggregation selection: "
                f"{int(np.sum((weights > 0) & (weights < 1.0)))} "
                f"expert(s) down-weighted of {report.num_active} "
                f"(threshold {report.threshold:.2f}); weighted "
                f"objective renormalizes by {report.renorm:.4f}"
            )
            return data, (None, torch.as_tensor(weights, dtype=data.x.dtype,
                                                device=data.x.device))
        keep = np.flatnonzero(~report.drop)
        # the kept experts all carry w_e = 1 in the compacted stack
        instr.agg_weights = weights[keep]
        instr.log_warning(
            f"aggregation selection: dropped {report.num_dropped} "
            f"redundant expert(s) of {report.num_active} before "
            f"factorization (threshold {report.threshold:.2f}); "
            f"objective renormalizes by {report.renorm:.4f}"
        )
        idx = torch.as_tensor(keep, device=data.x.device)
        return ExpertData(x=data.x[idx], y=data.y[idx], mask=data.mask[idx]), ()

    def _run_with_expert_resilience(self, instr: Instrumentation, data: ExpertData, run_fit):
        """Bounded recovery around one complete fit attempt.

        ``run_fit(data, extra, cache)`` is the whole optimize-to-PPA
        pipeline.  Selection runs first, then the gram cache is built from
        its stack.  On ``NotPositiveDefiniteException`` or
        ``NonFiniteFitError`` the per-expert health probe runs at the
        initial theta, unhealthy experts walk the jitter ladder, the
        irreparable ones are quarantined (and the cache rebuilt from the
        repaired stack), and the fit is retried with backoff.  A failure
        the probe cannot pin on experts is re-raised as it was; any other
        error (a CUDA error among them) propagates untouched."""
        from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException
        from spark_gp_tpu_torch.resilience.quarantine import NonFiniteFitError, diagnose_experts
        from spark_gp_tpu_torch.resilience.retry import (
            RetryBudgetExceededError,
            retry_with_backoff,
        )

        data, sel_extra = self._apply_expert_selection(instr, data)
        cache = self._gram_cache(self._get_kernel(), data)
        if not self._expert_quarantine or self._fit_retries < 1:
            return run_fit(data, sel_extra, cache)
        state = {"data": data, "extra": sel_extra, "cache": cache}
        # the probe needs an objective that decomposes over experts; the
        # ELBO's faults are diagnosed through the marginal NLL
        probe_objective = self._objective if self._objective in ("marginal", "loo") else "marginal"

        def attempt():
            return run_fit(state["data"], state["extra"], state["cache"])

        def recover(attempt_idx, exc):
            obs_trace.add_event("fit.retry", attempt=attempt_idx + 1, error=type(exc).__name__)
            kernel = self._get_kernel()
            report = diagnose_experts(kernel, kernel.init_theta(), state["data"],
                                      objective=probe_objective,
                                      allow_jitter=self._objective == "marginal")
            if report.clean:
                raise exc  # not a per-expert fault
            if report.num_jittered:
                instr.metrics["experts_jittered"] = report.num_jittered
                obs_trace.add_event("experts.jittered", count=report.num_jittered)
                instr.log_warning(
                    f"fit recovery: {report.num_jittered} expert(s) "
                    "repaired by adaptive jitter escalation "
                    f"(max relative jitter {report.jitter.max():.1e})"
                )
                # slot 0 is the jitter operand; selection's weights survive
                state["extra"] = (torch.as_tensor(report.jitter, dtype=state["data"].x.dtype,
                                                  device=state["data"].x.device),
                                  ) + tuple(state["extra"][1:])
            if report.num_dropped:
                state["data"] = self._apply_quarantine(instr, state["data"], report.bad,
                                                       "fit recovery")
                # the dropped experts have new (benign) rows
                state["cache"] = self._gram_cache(kernel, state["data"])
            instr.metrics["fit_retries"] = float(attempt_idx + 1)

        try:
            return retry_with_backoff(
                attempt, attempts=self._fit_retries + 1, base_delay_s=0.05,
                retry_on=(NotPositiveDefiniteException, NonFiniteFitError),
                on_retry=recover, describe=f"{type(self).__name__} fit",
            )
        except RetryBudgetExceededError as err:
            raise err.__cause__ from err

    @staticmethod
    def _emit_aggregation_stats(metrics: dict, data: ExpertData) -> None:
        """Stamp the engaged predict policy (``agg.policy``) and, unless
        selection already did, the effective expert count of the fitted
        stack (its active experts at unit weight)."""
        from spark_gp_tpu_torch.models import aggregation as agg

        metrics["agg.policy"] = agg.active_agg_policy()
        if "agg.effective_experts" not in metrics:
            active = (data.mask.sum(dim=1) > 0).cpu().numpy()
            metrics["agg.effective_experts"] = agg.effective_expert_count(
                active.astype(np.float64))

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
        if supports_matfree(kernel) and it_ops.resolve_for(data) == "matfree":
            return None
        return prepare_gram_cache(kernel, data.x)

    def _checkpoint_tag(self) -> str:
        """The checkpoint file's tag: the class name, plus the objective
        when it is not the marginal NLL, plus the ELBO's surface digest
        (``_objective_salt``): fits of different objectives or ELBO
        surfaces sharing a directory neither resume from nor overwrite each
        other's state."""
        name = type(self).__name__
        if self._objective == "marginal":
            return name
        name = f"{name}-{self._objective}"
        salt = getattr(self, "_objective_salt", None)
        if self._objective == "elbo" and salt:
            name += f"-{salt}"
        return name

    def _make_checkpointer(self, kernel: Kernel):
        """The per-iteration checkpoint callback under ``setCheckpointDir``
        (None without one), stamped with the fitted data's fingerprint and
        behind a staged preemption (``chaos.preempt_after_saves``)."""
        if self._checkpoint_dir is None:
            return None
        from spark_gp_tpu_torch.resilience import chaos
        from spark_gp_tpu_torch.utils.checkpoint import LbfgsCheckpointer

        inner = LbfgsCheckpointer(self._checkpoint_dir, kernel, tag=self._checkpoint_tag(),
                                  seed=self._seed, data=self._fit_data_key)
        return chaos.maybe_preempting(inner)

    def _resume_payload(self, kernel: Kernel, theta0: np.ndarray):
        """The payload of a checkpoint of this fit under
        ``setCheckpointDir``, or None.  Raises ``CheckpointMismatchError``
        for a checkpoint of another kernel structure and
        ``CheckpointCorruptError`` for a damaged one.  A payload with an
        evaluation log that was written for other data or another kernel
        spec (its ``data_fingerprint`` or ``kernel`` differs) belongs to
        another fit: it is not resumed, and the fit starts afresh and
        overwrites it, the JAX package's rule for its device checkpoints
        (replaying it would return that fit's theta without computing
        anything on this data).  A payload without the log (the JAX
        package's host format) carries neither, and is resumed from its
        theta."""
        if self._checkpoint_dir is None:
            return None
        from spark_gp_tpu_torch.utils.checkpoint import (
            CheckpointMismatchError,
            kernel_fingerprint,
            kernel_signature,
            load_checkpoint_payload,
            payload_state,
        )

        payload = load_checkpoint_payload(self._checkpoint_dir, tag=self._checkpoint_tag())
        if payload is None:
            return None
        _, theta, sig = payload_state(payload)
        expected = kernel_signature(kernel, theta0.shape[0])
        if theta.shape != theta0.shape or (sig is not None and sig != expected):
            raise CheckpointMismatchError(
                f"checkpoint in {self._checkpoint_dir!r} (tag {self._checkpoint_tag()!r}) "
                f"was written under a different kernel configuration ({sig!r} != "
                f"{expected!r}); clear the directory or use one per configuration"
            )
        if "evaluations" in payload and (
            payload.get("data_fingerprint") != self._fit_data_key
            or payload.get("kernel") != kernel_fingerprint(kernel)
        ):
            return None
        return payload

    def _optimize_hypers_body(
        self, kernel: Kernel, value_and_grad: Callable
    ) -> OptimizeResult:
        """Host L-BFGS-B from ``kernel.init_theta()`` within its bounds.

        Under ``setCheckpointDir`` every evaluation is logged and every
        iteration saved, and a checkpoint of this fit (same kernel
        structure, spec and data, :meth:`_resume_payload`) resumes it: the
        optimizer restarts from the initial theta with its evaluations
        answered from the log while the theta it asks for is the logged
        one (no objective is computed, no kernel launched), which rebuilds
        its state exactly, and runs live from there.  ``nit`` and ``nfev``
        count the live part only.  A payload without a log resumes from
        its theta with the remaining budget, and a checkpoint already at
        the budget returns its theta after one evaluation.  A
        ``SimulatedPreemption`` leaves with the evaluations it ran
        (``nfev``)."""
        from spark_gp_tpu_torch.resilience.chaos import SimulatedPreemption

        theta0 = kernel.init_theta()
        callback = self._make_checkpointer(kernel)
        payload = self._resume_payload(kernel, theta0)
        done, replay, max_iter = 0, [], self._max_iter
        if payload is not None:
            done = int(payload["iteration"])
            replay = payload.get("evaluations") or []
            if done >= self._max_iter:
                theta = np.asarray(payload["theta"], dtype=np.float64)
                value, _ = value_and_grad(theta)
                return OptimizeResult(
                    theta=theta, fun=float(value), nit=0, nfev=1, success=True,
                    resumed_from_iteration=done,
                    message="checkpoint already at the iteration budget; returning its iterate",
                )
            if not replay:
                # a payload without the log: from its theta, with the rest
                theta0, max_iter = np.asarray(payload["theta"], dtype=np.float64), max_iter - done
                callback.iteration = done
        live, replayed = [0], [0]

        def counted(theta):
            if replayed[0] < len(replay):
                rec_theta, value, grad = replay[replayed[0]]
                if np.array_equal(np.asarray(rec_theta), theta):
                    replayed[0] += 1
                    callback.record(theta, value, grad)
                    return value, np.asarray(grad, dtype=np.float64)
                replay.clear()  # the trajectory left the log: live from here
            live[0] += 1
            value, grad = value_and_grad(theta)
            if callback is not None:
                callback.record(theta, value, grad)
            return value, grad

        lower, upper = kernel.bounds()
        try:
            res = minimize_lbfgsb(
                counted,
                theta0,
                lower,
                upper,
                max_iter=max_iter,
                tol=self._tol,
                callback=callback,
                log_space=self._use_log_space(kernel),
            )
        except SimulatedPreemption as exc:
            exc.nfev = live[0]
            raise
        if replayed[0]:
            res.nit = max(0, res.nit - done)
        res.nfev = live[0]
        res.resumed_from_iteration = done
        return res

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
        one restart.  Raises ``NonFiniteFitError`` when no restart ends
        finite."""
        if self._num_restarts <= 1:
            res = self._optimize_hypers_body(kernel, value_and_grad)
            resumed = {"resumed_from_iteration": res.resumed_from_iteration} \
                if res.resumed_from_iteration else {}
            return res, resumed
        if self._checkpoint_dir is not None:
            raise ValueError(
                "setNumRestarts(>1) is not combinable with setCheckpointDir "
                "(restarts would overwrite one state file)"
            )
        results = [
            self._optimize_hypers_body(ThetaOverrideKernel(kernel, theta0), value_and_grad)
            for theta0 in self._restart_theta_batch(kernel)
        ]
        nlls = [res.fun if np.isfinite(res.fun) else np.inf for res in results]
        best = int(np.argmin(nlls))
        if not np.isfinite(nlls[best]):
            from spark_gp_tpu_torch.resilience.quarantine import NonFiniteFitError

            raise NonFiniteFitError(
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
        self, instr: Instrumentation, kernel: Kernel, theta_opt: np.ndarray, x: np.ndarray,
        y: np.ndarray, data: ExpertData, active: Optional[np.ndarray] = None,
    ) -> ppa.ProjectedProcessRawPredictor:
        """Active set -> (U1, u2) in float64 on the fit's device -> magic
        solve -> predictor.  ``active`` is a set selected before the
        optimization (the ELBO's), else the provider selects one at
        ``theta_opt``.  The statistics run in float64 because the normal
        equations square the conditioning (sigma2 as small as 1e-4)."""
        device = data.x.device
        if active is None:
            with instr.phase("active_set"):
                active = self._select_active(kernel, theta_opt, x, y, device)
        f64 = torch.float64
        with instr.phase("kmn_stats"):
            data64 = ExpertData(
                x=data.x.to(f64), y=data.y.to(f64), mask=data.mask.to(f64)
            )
            u1, u2 = ppa.kmn_stats(
                kernel,
                torch.as_tensor(np.asarray(theta_opt, dtype=np.float64), device=device),
                torch.as_tensor(np.asarray(active, dtype=np.float64), device=device),
                data64,
            )
            u1, u2 = u1.cpu().numpy(), u2.cpu().numpy()
        return self._build_predictor(instr, kernel, theta_opt, active, u1, u2, device)

    def _build_predictor(
        self, instr: Instrumentation, kernel: Kernel, theta, active, u1, u2, device
    ) -> ppa.ProjectedProcessRawPredictor:
        active64 = np.asarray(active, dtype=np.float64)
        with instr.phase("magic_solve"):
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
        resolved = it_ops.resolve_for(data)
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
