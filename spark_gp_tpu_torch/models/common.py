"""Estimator plumbing: the parameter setters and the training skeleton.

Setter names and defaults are the JAX package's (and the reference's).
The port adds ``setDevice``: entry points run on ``cuda`` unless the
caller asks for ``cpu`` (``utils/device.py``).

``setMesh`` splits the expert axis over the ranks of a process group
(``parallel/mesh.py``): every rank calls ``fit(x, y)`` with the same rows
and keeps its own block of the stack, or ``fit_distributed`` with its
block from ``parallel/distributed.distribute_global_experts``; the
objective, its gradient and the PPA statistics are summed over the ranks,
and every rank ends with the same model.  Under ``GP_DCN_MODE=1`` a fit
over a mesh of several ranks runs in the key-value-store mode
(:meth:`_dcn_scope`, ``parallel/coord.py``): every cross-rank sum is a
round over the group's store and the fit runs the host optimizer.  A
checkpoint directory under a mesh saves through the coordinated
checkpointers: rank 0 writes, every rank checks the digest, and a resume
on the same or another rank count continues from rank 0's state.

Every fit runs inside the observability shell (:meth:`_observed_fit`:
the root span ``fit.<Family>``, the kernel and memory capture, the run
journal, an incident bundle on a terminal classified failure), around
the degradation ladder (``resilience/fallback.py``), around the per-expert
recovery (:meth:`_run_with_expert_resilience`).
"""

from __future__ import annotations

import contextlib
import logging
import os
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

logger = logging.getLogger("spark_gp_tpu_torch")


def _every_restart_failed():
    """The multi-start drivers' error when no restart ends finite."""
    from spark_gp_tpu_torch.resilience.quarantine import NonFiniteFitError

    return NonFiniteFitError(
        "every restart produced a non-finite final NLL — the model "
        "configuration is numerically unusable at these settings"
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
        self._checkpoint_interval: int = 10
        self._optimizer: str = "auto"
        #: the fitted stack's fingerprint while a checkpointed fit optimizes
        self._fit_data_key: Optional[list] = None
        self._device = device
        #: the expert mesh (``parallel/mesh.ExpertMesh``), or None
        self._mesh = None
        #: the key-value-store fit context while a fit runs in that mode
        #: (``parallel/coord.DcnContext``), or None
        self._dcn_ctx = None

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
        """``"host"`` -- SciPy L-BFGS-B on the host, one device round trip
        per objective evaluation; ``"device"`` -- the whole L-BFGS-B loop
        on the fit's device (``optimize/lbfgs_device.py``), replayed from
        one captured CUDA graph on the card, for every estimator on every
        solver lane (EP's sweeps ignore the lane, as in the JAX package);
        ``"auto"`` (the default) -- ``"host"``: the rule that would pick
        the device loop waits for the port's benchmark (ROADMAP.md)."""
        if value not in ("auto", "host", "device"):
            raise ValueError("optimizer must be 'auto', 'host' or 'device'")
        self._optimizer = value
        return self

    def setNumRestarts(self, value: int, scale: float = 0.5):
        """Multi-start hyperparameter optimization: ``value`` > 1 runs
        L-BFGS-B from the kernel's initial theta and from ``value - 1``
        seeded perturbations of it (``scale`` wide; log-normal in the log
        hyper space, else relative-scale normal, clipped to the bounds)
        and keeps the lowest final objective: one after another on the
        host (:meth:`GaussianProcessCommons._optimize_with_restarts`, the
        classifiers' :meth:`GaussianProcessCommons._fit_with_restarts`),
        or, under ``setOptimizer("device")``, all at once in one batched
        device loop (the regression fit, the Laplace classifiers and the
        count models)."""
        if int(value) < 1:
            raise ValueError("number of restarts must be >= 1")
        self._num_restarts = int(value)
        self._restart_scale = float(scale)
        return self

    def setMesh(self, mesh):
        """Split the experts over the ranks of ``mesh``
        (``parallel/mesh.expert_mesh``), or ``None`` (the default) for one
        process: every rank runs the same fit on its own block of the
        expert stack, and the objective's value and gradient and the PPA
        statistics are all-reduced, so every rank ends with the same
        model.  ``fit(x, y)`` takes the same rows on every rank;
        ``fit_distributed`` takes each rank's own block."""
        from spark_gp_tpu_torch.parallel.mesh import ExpertMesh

        if mesh is not None and not isinstance(mesh, ExpertMesh):
            raise TypeError(
                f"setMesh takes an ExpertMesh (parallel/mesh.expert_mesh), got "
                f"{type(mesh).__name__}")
        self._mesh = mesh
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
        """Persist the optimizer's state for kill-and-resume.  Host
        optimizer: theta and the evaluation log are saved every L-BFGS-B
        iteration (``utils/checkpoint.LbfgsCheckpointer``), and a fit of
        the same kernel on the same data that finds its checkpoint in this
        directory resumes from it
        (:meth:`GaussianProcessCommons._optimize_hypers_body`).  Device
        optimizer: the fit runs in ``setCheckpointInterval``-iteration
        segments and the full optimizer state is saved between them
        (``utils/checkpoint.DeviceOptimizerCheckpointer``, the JAX
        package's file).  ``None`` (the default) saves nothing."""
        self._checkpoint_dir = None if path is None else str(path)
        return self

    def setCheckpointInterval(self, iters: int):
        """The device optimizer's segment length (default 10): iterations
        between its checkpoints under ``setCheckpointDir``, one host sync
        and one save each (the host optimizer saves every iteration)."""
        if int(iters) < 1:
            raise ValueError("checkpoint interval must be >= 1")
        self._checkpoint_interval = int(iters)
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
        """Precision lane of the gram contractions (``ops/precision.py``):
        ``"strict"`` (the default: IEEE float32 everywhere), ``"mixed"``
        (3xTF32 tensor-core grams, ``ops/lane_gram.py``) or ``"fast"``
        (1-pass TF32 grams, for experiments).  The factorizations and the
        float64 PPA statistics, solve and predict are lane-immune.  A
        fluent veneer over the process-wide setting
        (``set_precision_lane`` / ``GP_PRECISION_LANE``): it applies to
        every later fit.  A fit at a non-strict lane checks itself against
        the strict lane on one probe expert
        (``mixed_precision_guard.*`` in ``model.metrics``), with a warning
        (or, under ``GP_GUARD_ACTION=degrade``, a strict-lane re-fit) when
        the lane's bar is breached."""
        from spark_gp_tpu_torch.ops.precision import set_precision_lane

        set_precision_lane(value)
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
        gate, ``GP_RECORDER``).  The whole fit runs inside
        :meth:`_dcn_scope`, and under a mesh of several ranks its trace id
        is rank 0's (``coord.stitch_trace_token``), so every rank's journal
        of one fit carries the same ``trace_id``."""
        with self._dcn_scope():
            return self._observed_fit_body(instr, run)

    def _observed_fit_body(self, instr: Instrumentation, run):
        from spark_gp_tpu_torch.obs import recorder as obs_recorder
        from spark_gp_tpu_torch.obs import runtime as obs_runtime
        from spark_gp_tpu_torch.parallel import coord

        entry = f"fit.{instr.name}"
        if not obs_trace.tracing_enabled():
            try:
                return run()
            except Exception as exc:  # classified-failure-site: bundle + re-raise
                obs_recorder.record_fit_failure(exc, entry=entry, instr=instr)
                raise
        # one trace id for every rank of a fit over a mesh: rank 0's, over
        # the store (a plain fit keeps its own)
        token = coord.stitch_trace_token(self._coord_ctx_for_checkpoint())
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
        """``"host"`` under the ladder's ``host_f64`` rung (it re-runs the
        fit host-driven, whatever was asked for) and in the
        key-value-store mode (a store round a evaluation needs a host
        boundary a evaluation; nothing store-bound may enter a captured
        step), else the optimizer ``setOptimizer`` asked for; ``"auto"``
        is ``"host"`` until a measured rule says otherwise (ROADMAP.md)."""
        if self._fallback_mode == "host_f64" or getattr(self, "_dcn_ctx", None) is not None:
            return "host"
        return "device" if self._optimizer == "device" else "host"

    # --- the coordination plane (parallel/coord.py) ------------------------
    @contextlib.contextmanager
    def _dcn_scope(self):
        """Bind the key-value-store fit context (``coord.dcn_context``:
        ``GP_DCN_MODE=1`` over a group of several processes, or a test's
        context) to a fit over a mesh: inside, the mesh is the store mesh
        of the same ranks (``coord.store_mesh``: every collective a round
        over the store, no process-group collective), the optimizer is the
        host's, each evaluation's value and gradient and the (U1, u2)
        statistics are summed over the store, and checkpoints coordinate
        over it.  A fit without a mesh, or with the mode off, runs as it
        did."""
        from spark_gp_tpu_torch.parallel import coord

        ctx = coord.dcn_context() if self._mesh is not None \
            and getattr(self, "_dcn_ctx", None) is None else None
        with self._dcn_bound(ctx):
            yield ctx

    @contextlib.contextmanager
    def _dcn_bound(self, ctx):
        """``ctx`` bound and the mesh swapped for its store mesh on the
        mesh's device for the span of the block (nothing when ``ctx`` is
        None); both restored on exit."""
        if ctx is None:
            yield
            return
        from spark_gp_tpu_torch.parallel import coord
        from spark_gp_tpu_torch.parallel.mesh import _rank_device

        prev_ctx, prev_mesh = getattr(self, "_dcn_ctx", None), self._mesh
        device = prev_mesh.device if prev_mesh is not None else _rank_device(self._device)
        self._dcn_ctx, self._mesh = ctx, coord.store_mesh(ctx, device)
        try:
            yield
        finally:
            self._dcn_ctx, self._mesh = prev_ctx, prev_mesh

    def _coord_ctx_for_checkpoint(self):
        """The context the checkpoint writers coordinate over: the
        store-mode context when one is bound, else -- under a mesh of
        several ranks -- the process's cached bare context over the
        group's store (``coord.checkpoint_coordination_context``), else
        None.  A plain fit without a mesh keeps plain local writers: two
        independent fits must never meet on the store."""
        from spark_gp_tpu_torch.parallel import coord

        ctx = getattr(self, "_dcn_ctx", None)
        if ctx is not None:
            return ctx
        if not self._mesh_of_ranks():
            return None
        return coord.checkpoint_coordination_context()

    def _global_data_key(self, data: ExpertData) -> list:
        """The content fingerprint of the stack being fitted
        (``utils/checkpoint.stack_fingerprint``: over the experts that
        hold a point, so the padding that evens out the ranks does not
        count), of the whole stack under a mesh: every rank's block's sums,
        summed over the ranks, so every rank's checkpoint payload (and its
        digest) is the same."""
        from spark_gp_tpu_torch.utils.checkpoint import stack_fingerprint

        return stack_fingerprint(data.x, data.y, data.mask,
                                 self._mesh if self._mesh_of_ranks() else None)[0]

    # --- the device optimizer's plumbing ---------------------------------
    def _fallback_segmented(self) -> bool:
        """True while the ladder's ``segmented`` rung runs: the device fit
        goes through the segment driver with an in-memory saver and half
        the segment length."""
        return self._fallback_mode == "segmented"

    def _segment_saver_and_chunk(self, file_tag: str, data: ExpertData):
        """``(saver, chunk)`` of a segmented device fit of ``data``: the
        checkpointer and the configured interval under
        ``setCheckpointDir``; the ladder's in-memory saver and half the
        interval on the ``segmented`` rung of a fit that asked for no
        durability."""
        if self._checkpoint_dir is not None:
            return self._make_device_checkpointer(file_tag, data), self._checkpoint_interval
        from spark_gp_tpu_torch.resilience.fallback import NullSegmentSaver, fallback_segment_chunk

        return NullSegmentSaver(), fallback_segment_chunk(self._checkpoint_interval)

    def _make_device_checkpointer(self, file_tag: str, data: ExpertData):
        """The device optimizer's segment saver, stamped with the elastic
        metadata (``coord.elastic_meta``: the process count, the mesh and
        the global expert assignment of ``data``), in the coordinated shell
        under a mesh (``coord.CoordinatedDeviceCheckpointer``: rank 0
        writes, every rank checks the digest, a load ships rank 0's state),
        and behind a staged preemption (``chaos.preempt_after_saves``)."""
        from spark_gp_tpu_torch.parallel import coord
        from spark_gp_tpu_torch.resilience import chaos
        from spark_gp_tpu_torch.utils.checkpoint import DeviceOptimizerCheckpointer

        ctx = self._coord_ctx_for_checkpoint()
        world = 1 if self._mesh is None else self._mesh.world_size
        elastic = coord.elastic_meta(
            self._mesh, num_experts=int(data.x.shape[0]) * world,
            expert_size=int(data.x.shape[1]),
            process_count=None if ctx is None else ctx.num_processes)
        saver = DeviceOptimizerCheckpointer(self._checkpoint_dir, file_tag, elastic=elastic)
        if self._mesh is not None:
            saver = coord.CoordinatedDeviceCheckpointer(saver, ctx)
        return chaos.maybe_preempting(saver)

    def _mesh_of_ranks(self) -> bool:
        """True under a mesh of more than one rank."""
        return self._mesh is not None and self._mesh.world_size > 1

    def _device_fit_op(self) -> str:
        """The chaos choke point's name for the device fit about to run:
        staged faults scope to one dispatch shape, so an injected
        one-dispatch OOM leaves the segmented rung's fit clean."""
        if self._checkpoint_dir is not None or self._fallback_segmented():
            return "fit.device.segment"
        if self._mesh is not None:
            return "fit.device.sharded"
        return "fit.device.one_dispatch"

    def _use_batched_multistart(self) -> bool:
        """The batched device multi-start applies to a device fit without a
        checkpoint directory (the sequential driver covers the rest)."""
        return (
            self._num_restarts > 1
            and self._resolved_optimizer() == "device"
            and self._checkpoint_dir is None
        )

    def _report_multistart_nlls(self, metrics: dict, nlls) -> None:
        """Per-restart reporting of a batched multi-start: raises the
        sequential driver's error when no lane ended finite, else records
        each restart's NLL and the restart count."""
        nlls = np.asarray(nlls, dtype=np.float64)
        if not np.any(np.isfinite(nlls)):
            raise _every_restart_failed()
        for r, nll in enumerate(nlls):
            metrics[f"restart_{r}_nll"] = float(nll) if np.isfinite(nll) else np.inf
        metrics["num_restarts"] = self._num_restarts

    @staticmethod
    def _finalize_device_fit(pending: dict) -> dict:
        """The device fit's results read back in one transfer: ``pending``
        maps names to device tensors (theta, the scalars, the restart
        NLLs), the result the same names to float64 numpy arrays."""
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64) for v in pending.values()])
        host = flat.cpu().numpy()
        out, at = {}, 0
        for key, value in pending.items():
            n = value.numel()
            out[key] = host[at:at + n].reshape(tuple(value.shape))
            at += n
        return out

    @staticmethod
    def _device_loop_metrics(loop: dict) -> dict:
        """The device loop's record (``lbfgs_device.DeviceLoop.counts``)
        as fit metrics."""
        keys = ("captures", "replays", "eager_steps", "masked_evaluations", "host_syncs",
                "capture_seconds", "graph_nodes", "warmup_evaluations", "newton_iterations",
                "gradient_passes", "eager_newton_iterations", "eager_evaluations", "newton_k",
                "pass_k1_calls")
        out = {f"device_opt.{k}": float(loop[k]) for k in keys if loop.get(k) is not None}
        if loop.get("resumed_from_iteration"):
            out["resumed_from_iteration"] = loop["resumed_from_iteration"]
        return out

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

    def _dispatch_raw_bytes(self, data: ExpertData) -> Optional[float]:
        """Modeled raw peak bytes of one objective evaluation of the fit
        about to run (``memplan.fit_dispatch_bytes`` at the resolved lane's
        rung, or at ``segmented`` on that rung, in the stack's dtype); arms
        the memory planner's calibration loop with it.  None for a sharded
        fit, which the planner skips (the JAX package's rule: a rank's
        footprint has no model yet)."""
        from spark_gp_tpu_torch.resilience import memplan

        if self._mesh is not None:
            return None

        e, s, p = (int(d) for d in data.x.shape)
        rung = "segmented" if self._fallback_segmented() else memplan.fit_rung_of_lane(
            it_ops.resolve_for(data), supports_matfree(self._get_kernel()))
        n_targets = int(data.y.shape[2]) if data.y.ndim == 3 else 1
        family = type(self).__name__
        raw = memplan.fit_dispatch_bytes(e, s, p, data.x.element_size(), rung, n_targets,
                                         family, self._device_latent_heads())
        # arm the calibration loop: the metered peak of the dispatch about
        # to run judges this model (obs/cost.py, GP_XLA_COST)
        memplan.note_expected_dispatch(memplan.fit_model_key(family, rung), raw)
        return raw

    #: the latent heads of a Laplace family's device fit (the memory
    #: planner's latent and B stacks): 1 binary and count models, the
    #: class count multiclass; 0 for the regression fit
    _latent_heads = 0

    def _device_latent_heads(self) -> int:
        """:attr:`_latent_heads` under the device optimizer, else 0."""
        return self._latent_heads if self._resolved_optimizer() == "device" else 0

    @contextlib.contextmanager
    def _optimize_phase(self, instr: Instrumentation, data: ExpertData):
        """The ``optimize_hypers`` phase around the host optimizer, opened
        by the ``fit.host`` fault-injection point.  Unlike the JAX
        package's, that point passes the resolved lane's modeled bytes, so
        a staged ``chaos.memory_limit_bytes`` acts on the host path: the
        port has no other.  Under ``setCheckpointDir`` it also takes the
        content fingerprint of the stack being fitted (of the whole stack
        under a mesh, :meth:`_global_data_key`), which ties a checkpoint's
        evaluation log to its data (:meth:`_resume_payload`)."""
        from spark_gp_tpu_torch.resilience import chaos

        if self._resolved_optimizer() != "device":
            # a device fit has its own choke point (``_device_fit_op``)
            chaos.maybe_injected_failure("fit.host", nbytes=self._dispatch_raw_bytes(data))
        self._fit_data_key = None if self._checkpoint_dir is None else \
            self._global_data_key(data)
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
        """The expert stack of ``(x, y)`` on ``device``; under a mesh, this
        rank's block of it (``parallel/mesh.shard_experts``)."""
        data = group_for_experts(
            x, y, self._dataset_size_for_expert,
            dtype=working_dtype(device), device=device,
        )
        if self._mesh is not None:
            from spark_gp_tpu_torch.parallel.mesh import shard_experts

            data = shard_experts(data, self._mesh)
        return data

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
            if self._mesh is not None:
                # the flags of this rank's block; padded experts are inert
                from spark_gp_tpu_torch.parallel.mesh import shard_rows

                bad_experts = shard_rows(bad_experts, self._mesh, fill=False)
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
            renorm_factor,
        )

        bad = np.asarray(bad, dtype=bool)
        n_bad = int(bad.sum())
        active = int((data.mask.sum(dim=1) > 0).sum())
        mesh = self._mesh
        if mesh is not None:
            # the counts are the mesh's, so every rank renormalizes alike
            n_bad, active = (int(v) for v in mesh.all_reduce_host([n_bad, active]))
        if n_bad == 0:
            return data
        if n_bad >= active:
            raise ExpertQuarantineError(
                f"{source}: all {active} active expert(s) are non-finite — "
                + GLOBAL_FAILURE_ADVICE
            )
        # a rank whose every expert is bad has no finite row of its own to
        # stand in for the dropped features (one process alone never gets
        # here with every expert bad: it raised above)
        benign = torch.zeros_like(data.x[0, :1]) if bad.all() else None
        data = data.with_experts_masked(bad, benign)
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

    def _apply_expert_selection(self, instr: Instrumentation, data: ExpertData,
                                num_experts: Optional[int] = None):
        """Fit-time expert selection (``models/aggregation.py``), before any
        objective evaluation: ``drop`` mode compacts the stack to the kept
        experts, ``downweight`` mode hands back fractional weights for the
        marginal objective.  Returns ``(data, extra)``, ``extra`` either
        ``()`` or the marginal objective's ``(None, weights)`` (slot 0 is
        the recovery loop's jitter).  Off unless ``GP_AGG_SELECT``.

        Under a mesh ``data`` is this rank's block and the report the
        global stack's (``num_experts`` its count before the mesh's
        padding), the same on every rank: ``instr.agg_weights`` and the
        ``agg.*`` metrics are the report's; each rank keeps its block's
        weights (``downweight``), or its block's kept experts (``drop``),
        padded with inert experts to the largest kept count of any rank,
        so the blocks stay equal for the mesh's gathers."""
        from spark_gp_tpu_torch.models import aggregation as agg

        if not agg.selection_enabled():
            return data, ()
        mesh = self._mesh
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
        report = agg.select_experts(data, mode=mode, seed=self._seed, mesh=mesh,
                                    num_experts=num_experts)
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
            if mesh is not None:
                from spark_gp_tpu_torch.parallel.mesh import shard_rows

                weights = shard_rows(weights, mesh)
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
        if mesh is not None:
            return self._kept_block(data, ~report.drop, mesh), ()
        idx = torch.as_tensor(keep, device=data.x.device)
        return ExpertData(x=data.x[idx], y=data.y[idx], mask=data.mask[idx]), ()

    @staticmethod
    def _kept_block(data: ExpertData, kept, mesh) -> ExpertData:
        """This rank's block of a selection's ``kept`` flags (global, the
        same on every rank): its kept experts, then inert copies of its
        first expert (zero labels and mask) up to the largest kept count of
        any rank, which every rank reads off the same flags."""
        per = kept.shape[0] // mesh.world_size
        counts = kept.reshape(mesh.world_size, per).sum(axis=1)
        idx = torch.as_tensor(np.flatnonzero(kept[mesh.rank * per:(mesh.rank + 1) * per]),
                              device=data.x.device, dtype=torch.long)
        pad = int(counts.max()) - idx.numel()
        first = (data.x[:1], torch.zeros_like(data.y[:1]), torch.zeros_like(data.mask[:1]))
        parts = [torch.cat([part[idx], tmpl.repeat((pad,) + (1,) * (tmpl.ndim - 1))])
                 for part, tmpl in zip((data.x, data.y, data.mask), first)]
        return ExpertData(x=parts[0], y=parts[1], mask=parts[2])

    def _run_with_expert_resilience(self, instr: Instrumentation, data: ExpertData, run_fit,
                                    num_experts: Optional[int] = None):
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

        data, sel_extra = self._apply_expert_selection(instr, data, num_experts)
        cache = self._gram_cache(self._get_kernel(), data)
        if not self._expert_quarantine or self._fit_retries < 1 or self._mesh_of_ranks():
            # over several ranks a failed attempt propagates: a probe of one
            # rank's experts cannot decide a retry every rank must join
            # (the data screen still quarantines before the fit)
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
                                      # the sharded objectives carry no jitter
                                      allow_jitter=(self._objective == "marginal"
                                                    and self._mesh is None))
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
                # per-expert jitter levels ride into the post-fit quality
                # probe (_emit_expert_quality) and the run journal
                instr.expert_jitter = np.asarray(report.jitter, dtype=np.float64)
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
        the elastic metadata (``coord.elastic_meta``), in the coordinated
        shell under a mesh (``coord.CoordinatedLbfgsCheckpointer``: rank 0
        writes, every rank checks the digest) and behind a staged
        preemption (``chaos.preempt_after_saves``)."""
        if self._checkpoint_dir is None:
            return None
        from spark_gp_tpu_torch.parallel import coord
        from spark_gp_tpu_torch.resilience import chaos
        from spark_gp_tpu_torch.utils.checkpoint import LbfgsCheckpointer

        ctx = self._coord_ctx_for_checkpoint()
        inner = LbfgsCheckpointer(
            self._checkpoint_dir, kernel, tag=self._checkpoint_tag(), seed=self._seed,
            data=self._fit_data_key,
            elastic=coord.elastic_meta(
                self._mesh, process_count=None if ctx is None else ctx.num_processes))
        if self._mesh is not None:
            inner = coord.CoordinatedLbfgsCheckpointer(inner, ctx)
        return chaos.maybe_preempting(inner)

    def _resume_payload(self, kernel: Kernel, theta0: np.ndarray):
        """The payload of a checkpoint of this fit under
        ``setCheckpointDir``, or None.  Raises ``CheckpointMismatchError``
        for a checkpoint of another kernel structure and
        ``CheckpointCorruptError`` for a damaged one.  A payload with an
        evaluation log that was written for other data or another kernel
        spec (its ``data_fingerprint`` or ``kernel_fingerprint`` differs)
        belongs to another fit: it is not resumed, and the fit starts afresh and
        overwrites it, the JAX package's rule for its device checkpoints
        (replaying it would return that fit's theta without computing
        anything on this data).  A payload without the log (the JAX
        package's host format) carries neither, and is resumed from its
        theta.

        Under a mesh of several ranks only rank 0 is sure to hold the file
        (it is the writer), so rank 0 reads it and ships it over the store,
        and every rank resumes from the same state.  A payload stamped by
        another process count is an elastic resume, counted
        (``coord.elastic_resumes``) and marked by a span event, then
        resumed: theta is replicated."""
        if self._checkpoint_dir is None:
            return None
        import json

        from spark_gp_tpu_torch.utils.checkpoint import (
            SUMMATION_RTOL,
            CheckpointMismatchError,
            fingerprints_match,
            kernel_fingerprint,
            kernel_signature,
            load_checkpoint_payload,
            note_elastic_resume,
            payload_state,
        )

        ctx = self._coord_ctx_for_checkpoint()
        payload = None
        if ctx is None or ctx.process_id == 0:
            payload = load_checkpoint_payload(self._checkpoint_dir, tag=self._checkpoint_tag())
        if ctx is not None and ctx.num_processes > 1:
            blob = json.dumps(payload or {}).encode()
            payload = json.loads(ctx.allgather_bytes("ckpt_resume", blob)[0].decode()) or None
        if payload is None:
            return None
        elastic = payload.get("elastic")
        stored = None if elastic is None else elastic.get("process_count")
        current = 1 if ctx is None else ctx.num_processes
        _, theta, sig = payload_state(payload)
        expected = kernel_signature(kernel, theta0.shape[0])
        if theta.shape != theta0.shape or (sig is not None and sig != expected):
            raise CheckpointMismatchError(
                f"checkpoint in {self._checkpoint_dir!r} (tag {self._checkpoint_tag()!r}) "
                f"was written under a different kernel configuration ({sig!r} != "
                f"{expected!r}); clear the directory or use one per configuration"
            )
        # exact on the same rank count; another count sums in another order
        rtol = 0.0 if stored in (None, current) else SUMMATION_RTOL
        if "evaluations" in payload and (
            not fingerprints_match(payload.get("data_fingerprint"), self._fit_data_key, rtol)
            or payload.get("kernel_fingerprint") != kernel_fingerprint(kernel)
        ):
            return None
        if stored not in (None, current):
            note_elastic_resume(stored, current)
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

        from spark_gp_tpu_torch.parallel import coord

        lower, upper = kernel.bounds()
        # SIGTERM watch only while a save boundary exists to act on it
        watch = coord.preemption_watch() if callback is not None else contextlib.nullcontext()
        try:
            with watch:
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
        self._check_restarts_without_checkpoints()
        results = [
            self._optimize_hypers_body(ThetaOverrideKernel(kernel, theta0), value_and_grad)
            for theta0 in self._restart_theta_batch(kernel)
        ]
        nlls = [res.fun if np.isfinite(res.fun) else np.inf for res in results]
        best = int(np.argmin(nlls))
        if not np.isfinite(nlls[best]):
            raise _every_restart_failed()
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

    def _check_restarts_without_checkpoints(self) -> None:
        """Restarts would overwrite one state file: several restarts with a
        checkpoint directory are refused (the JAX package's rule)."""
        if self._num_restarts > 1 and self._checkpoint_dir is not None:
            raise ValueError(
                "setNumRestarts(>1) is not combinable with setCheckpointDir "
                "(restarts would overwrite one state file)"
            )

    def _fit_with_restarts(self, outer_instr: Instrumentation, fit_once):
        """The generic sequential multi-start driver (the JAX package's):
        ``fit_once(kernel, instr)`` runs one complete fit and returns a
        model whose ``metrics`` carry ``final_nll``.  Restart 0 runs on
        ``outer_instr`` from the kernel's initial theta; restart r >= 1 on
        a fresh Instrumentation seeded with the pre-fit metrics and
        timings, from row r of :meth:`_restart_theta_batch` (every restart
        through a :class:`ThetaOverrideKernel`).  A restart that raises
        ``NonFiniteFitError`` scores +inf; the lowest finite final NLL
        wins (the first on a tie) and carries ``restart_{r}_nll``,
        ``num_restarts`` and ``best_restart``."""
        from spark_gp_tpu_torch.resilience.quarantine import NonFiniteFitError

        kernel = self._get_kernel()
        if self._num_restarts <= 1:
            return fit_once(kernel, outer_instr)
        self._check_restarts_without_checkpoints()
        theta_batch = self._restart_theta_batch(kernel)
        base_metrics = dict(outer_instr.metrics)
        base_timings = dict(outer_instr.timings)
        best_model, best_nll, best_r = None, np.inf, -1
        nlls = []
        for r in range(self._num_restarts):
            if r == 0:
                instr_r = outer_instr
            else:
                instr_r = Instrumentation(name=outer_instr.name)
                instr_r.metrics.update(base_metrics)
                instr_r.timings.update(base_timings)
            try:
                model = fit_once(ThetaOverrideKernel(kernel, theta_batch[r]), instr_r)
            except NonFiniteFitError:
                nlls.append(np.inf)
                continue
            nll = float(model.metrics.get("final_nll", np.inf))
            nlls.append(nll if np.isfinite(nll) else np.inf)
            if nlls[-1] < best_nll:
                best_model, best_nll, best_r = model, nlls[-1], r
        if best_model is None:
            raise _every_restart_failed()
        for r, nll in enumerate(nlls):
            best_model.metrics[f"restart_{r}_nll"] = nll
        best_model.metrics["num_restarts"] = self._num_restarts
        best_model.metrics["best_restart"] = best_r
        self._log_renormalized_nll(best_model.metrics)
        return best_model

    # --- the sharded fit ---------------------------------------------------
    @contextlib.contextmanager
    def _stack_mesh(self, data: ExpertData):
        """The mesh of a ``fit_distributed`` call: ``setMesh``'s, else the
        default process group's (``parallel/distributed.global_expert_mesh``;
        a mesh of this process alone without one) on the stack's device;
        the estimator's own mesh is restored on exit, so it stays reusable
        for ``fit``."""
        from spark_gp_tpu_torch.parallel.distributed import global_expert_mesh

        prev = self._mesh
        if self._mesh is None:
            self._mesh = global_expert_mesh(data.x.device)
        try:
            yield self._mesh
        finally:
            self._mesh = prev

    def _run_fit_distributed(self, name: str, data: ExpertData, active_set, prepare):
        """The shell of every estimator's ``fit_distributed`` (the JAX
        package's): resolve the mesh, then, inside the observability shell
        and the distributed ladder (``fallback.run_distributed_ladder``),
        the data screen on this rank's block and ``prepare(instr, active64,
        data) -> fit_once(kernel, instr)`` through the family's restart
        driver (:meth:`_fit_distributed_body`).  ``prepare`` must use the
        ``data`` it is handed (the screened stack), never its caller's."""
        from spark_gp_tpu_torch.resilience import fallback

        if not isinstance(data, ExpertData):
            raise TypeError(
                "fit_distributed takes this rank's ExpertData block "
                "(parallel/distributed.distribute_global_experts)")
        instr = Instrumentation(name=name)
        with self._stack_mesh(data):
            return self._observed_fit(instr, lambda: fallback.run_distributed_ladder(
                self, instr, data, active_set, prepare))

    def _fit_distributed_body(self, instr: Instrumentation, data: ExpertData, active_set,
                              prepare):
        """One attempt of the distributed fit: the data screen on the
        rank-local block (the JAX package screens host-local stacks so; the
        quarantine counts are the mesh's), the explicit active set in
        float64, then the family's fit of the stack."""
        from spark_gp_tpu_torch.resilience.quarantine import nonfinite_expert_mask

        instr.metrics["num_experts"] = int(data.num_experts) * (
            1 if self._mesh is None else self._mesh.world_size)
        instr.metrics["expert_size"] = int(data.expert_size)
        if self._expert_quarantine:
            bad = nonfinite_expert_mask(data)
            data = self._apply_quarantine(instr, data, bad, "data screen")
        active64 = None if active_set is None else np.asarray(active_set, dtype=np.float64)
        fit_once = prepare(instr, active64, data)
        return self._stack_fit_with_restarts(instr, fit_once)

    def _stack_fit_with_restarts(self, instr: Instrumentation, fit_once):
        """The restart driver of a fit from a stack: the Laplace families'
        (:meth:`_latent_fit_with_restarts`); regression runs its restarts
        inside one fit and overrides this."""
        return self._latent_fit_with_restarts(instr, fit_once)

    @staticmethod
    def _provider_stack(data: ExpertData) -> ExpertData:
        """The stack a ``from_stack`` provider selects off: the PPA stack,
        with a multiclass stack's ``[E, s, C]`` latents reduced to each
        point's strongest class latent (the host rows' targets)."""
        if data.y.ndim == 3:
            return ExpertData(x=data.x, y=torch.max(data.y, dim=-1).values, mask=data.mask)
        return data

    def _gathered_stack(self, values: torch.Tensor, num_experts: int) -> np.ndarray:
        """A per-expert ``[E_local, ...]`` device array of this rank, as the
        whole ``[E, ...]`` stack's numpy (every rank's block in rank order,
        the padding dropped); the array itself without a mesh."""
        if self._mesh is None:
            return values.cpu().numpy()
        return torch.cat(self._mesh.all_gather(values.contiguous())).cpu().numpy()[:num_experts]

    def _device_fit_prelude(self, kernel: Kernel, data: ExpertData):
        """The checks and operands every device fit starts with: no
        restarts beside a checkpoint directory, the staged fault of the
        dispatch about to run (``_device_fit_op``); returns ``(dev, lower,
        upper, log_space)``, ``dev`` casting an array to the stack's dtype
        and device."""
        from spark_gp_tpu_torch.resilience import chaos

        self._check_restarts_without_checkpoints()
        dtype, device = data.x.dtype, data.x.device

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        lower, upper = (dev(b) for b in kernel.bounds())
        log_space = self._use_log_space(kernel)
        chaos.maybe_injected_failure(self._device_fit_op(), nbytes=self._dispatch_raw_bytes(data))
        return dev, lower, upper, log_space

    def _device_fit_result(self, host: dict, loop: dict, multistart: bool):
        """``(OptimizeResult, metrics)`` of a device fit from its results
        read back (``_finalize_device_fit``) and its loop's record; raises
        ``NonFiniteFitError`` for a non-finite final objective of a single
        start (the loop cannot raise mid-flight)."""
        from spark_gp_tpu_torch.resilience.quarantine import NonFiniteFitError

        stalled = bool(host["stalled"])
        res = OptimizeResult(
            theta=np.asarray(host["theta"], dtype=np.float64), fun=float(host["f"]),
            nit=int(host["n_iter"]), nfev=int(host["n_fev"]), success=not stalled,
            message="line search stalled" if stalled else "converged or at the iteration budget",
            resumed_from_iteration=int(loop.get("resumed_from_iteration", 0)),
        )
        metrics = {"optimizer": "device", "lbfgs_stalled": float(stalled),
                   **self._device_loop_metrics(loop)}
        if multistart:
            self._report_multistart_nlls(metrics, host["f_all"])
            metrics["best_restart"] = int(host["best"])
        elif self._expert_quarantine and not np.isfinite(res.fun):
            raise NonFiniteFitError("device fit converged to a non-finite objective")
        return res, metrics

    def _latent_device_fit(self, kernel: Kernel, data: ExpertData, lanes, kind: str,
                           file_tag: str, **meta_extra):
        """The device optimizer's fit of a Laplace family, one attempt (the
        JAX package's ``_fit_device`` and ``_fit_device_multistart`` of the
        classifiers and count models): the batched multi-start for several
        restarts, the segment driver under ``setCheckpointDir`` or the
        ladder's ``segmented`` rung (``kind`` and ``meta_extra`` the JAX
        ``segment_meta``'s, ``file_tag`` the state file's), else one loop;
        ``lanes`` is the family's ``models/laplace_device.LaplaceLanes``.
        The results come back in one transfer.  Under a mesh every driver
        runs the sharded fit (``laplace_device.ShardedLanes``: this rank's
        latent modes, one all-reduce of the lanes' values and gradients a
        step).  Returns ``(OptimizeResult, latent modes [E, s, ...] on the
        device, metrics)``."""
        from spark_gp_tpu_torch.models import laplace_device as ld

        dev, lower, upper, log_space = self._device_fit_prelude(kernel, data)
        mesh = self._mesh
        loop: dict = {}
        multistart = self._use_batched_multistart()
        names = ("theta", "latent", "f", "n_iter", "n_fev", "stalled")
        if multistart:
            out = ld.fit_latent_device_multistart(
                lanes, log_space, dev(self._restart_theta_batch(kernel)), lower, upper,
                self._max_iter, self._tol, loop_metrics=loop, mesh=mesh)
            names += ("f_all", "best")
        elif self._checkpoint_dir is not None or self._fallback_segmented():
            saver, chunk = self._segment_saver_and_chunk(file_tag, data)
            out = ld.fit_latent_device_checkpointed(
                lanes, kind, log_space, dev(kernel.init_theta()), lower, upper, self._max_iter,
                self._tol, chunk, saver, loop_metrics=loop, mesh=mesh, **meta_extra)
        else:
            out = ld.fit_latent_device(lanes, log_space, dev(kernel.init_theta()), lower, upper,
                                       self._max_iter, self._tol, loop_metrics=loop, mesh=mesh)
        pending = dict(zip(names, out))
        latent = pending.pop("latent")
        res, metrics = self._device_fit_result(self._finalize_device_fit(pending), loop,
                                               multistart)
        metrics.update(newton_iterations=int(loop.get("newton_iterations", 0)),
                       objective_calls=int(loop.get("gradient_passes", 0)))
        return res, latent, metrics

    def _latent_fit_with_restarts(self, instr: Instrumentation, fit_once):
        """The restarts of a Laplace family: one batched device loop under
        the device optimizer (``fit_once`` runs once and its fit takes every
        restart), else the sequential driver."""
        if self._use_batched_multistart():
            return fit_once(self._get_kernel(), instr)
        return self._fit_with_restarts(instr, fit_once)

    @staticmethod
    def _resumed_metric(res) -> dict:
        """``resumed_from_iteration`` of a fit that resumed from a
        checkpoint, as a metric; nothing for a fresh fit."""
        done = int(getattr(res, "resumed_from_iteration", 0) or 0)
        return {"resumed_from_iteration": done} if done else {}

    def _optimize_latent_host(self, kernel: Kernel, objective: Callable, f0):
        """Host L-BFGS-B over a latent-carrying objective ``(theta, f0) ->
        (value, grad, f_new)``: every evaluation, line-search trials
        included, starts from the latent modes the previous one left
        (the reference mutates them in place, GPClf.scala:53-60), and one
        last evaluation at theta* settles them (GPClf.scala:60).  Under a
        mesh, ``objective`` is this rank's: its value and gradient are
        all-reduced here (``parallel/mesh.allreduced_objective``, what each
        family's ``make_sharded_*`` objective is), its latent carry stays
        local.  Returns ``(OptimizeResult, f_final)``."""
        if self._mesh is not None:
            from spark_gp_tpu_torch.parallel.mesh import allreduced_objective

            objective = allreduced_objective(objective, self._mesh)
        state = {"f": f0}

        def value_and_grad(theta):
            value, grad, state["f"] = objective(theta, state["f"])
            return value, grad

        res = self._optimize_hypers_body(kernel, value_and_grad)
        _, _, f_final = objective(res.theta, state["f"])
        return res, f_final

    def _select_active(self, kernel, theta, x, y, device, data=None) -> np.ndarray:
        """The configured provider's ``[m, p]`` rows; the k-means and
        greedy providers run on the fit's ``device``.  ``x`` None (the
        distributed fit, where no rank holds every row): the provider
        selects off the stack ``data`` (``from_stack``; ``data.y`` carries
        the targets) over the fit's mesh."""
        provider = self._active_set_provider
        if x is None:
            return np.asarray(provider.from_stack(
                self._active_set_size, data, kernel, np.asarray(theta, dtype=np.float64),
                self._seed, self._mesh))
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
        equations square the conditioning (sigma2 as small as 1e-4), and
        stay on the device for the solve (``[m, m]`` is 134 MB at m =
        4096); the phase ends when they are ready."""
        device = data.x.device
        if active is None:
            with instr.phase("active_set"):
                active = self._select_active(kernel, theta_opt, x, y, device,
                                             self._provider_stack(data))
        f64 = torch.float64
        with instr.phase("kmn_stats"):
            data64 = ExpertData(
                x=data.x.to(f64), y=data.y.to(f64), mask=data.mask.to(f64)
            )
            theta_t = torch.as_tensor(np.asarray(theta_opt, dtype=np.float64), device=device)
            active_t = torch.as_tensor(np.asarray(active, dtype=np.float64), device=device)
            dcn = getattr(self, "_dcn_ctx", None)
            if dcn is not None:
                # the store mode: this rank's sums, then one round over the
                # store summed in rank order -- every rank solves alike
                u1, u2 = ppa.kmn_stats(kernel, theta_t, active_t, data64)
                u1, u2 = (torch.as_tensor(a, device=device) for a in dcn.allreduce_arrays(
                    "kmn_stats", u1.cpu().numpy(), u2.cpu().numpy()))
            elif self._mesh is None:
                u1, u2 = ppa.kmn_stats(kernel, theta_t, active_t, data64)
            else:
                # each rank's sums, all-reduced: every rank solves alike
                u1, u2 = ppa.kmn_stats_sharded(kernel, self._mesh, theta_t, active_t, data64)
            if u1.is_cuda:
                torch.cuda.synchronize(u1.device)
        return self._build_predictor(instr, kernel, theta_opt, active, u1, u2, device, data)

    def _build_predictor(
        self, instr: Instrumentation, kernel: Kernel, theta, active, u1, u2, device,
        data: Optional[ExpertData] = None,
    ) -> ppa.ProjectedProcessRawPredictor:
        """The magic solve (``ppa.magic_solve``: on the host, or on the
        fit's device from ``ppa._DEVICE_SOLVE_MIN_M`` active points on,
        row-sharded over the fit's mesh of several ranks, on the statistics
        ``u1``, ``u2`` where the fit built them), the
        fit-time precision guard on ``data`` (the fitted stack), and the
        predictor, which downloads the statistics only where it keeps
        them."""
        active64 = np.asarray(active, dtype=np.float64)
        # the store mode's ranks hold the same summed statistics: each
        # solves them whole rather than row-sharded over store rounds
        solve_mesh = None if getattr(self, "_dcn_ctx", None) is not None else self._mesh
        with instr.phase("magic_solve"):
            magic_vector, magic_matrix = ppa.magic_solve(
                kernel, theta, active64, u1, u2,
                with_variance=self._predictive_variance, device=device, mesh=solve_mesh,
            )
        self._emit_precision_guard(instr, kernel, theta, data)
        self._emit_expert_quality(instr, kernel, theta, data)
        self._emit_covariate_summary(instr, data, active64)
        return ppa.ProjectedProcessRawPredictor(
            kernel=kernel,
            theta=np.asarray(theta, dtype=np.float64),
            active=active64,
            magic_vector=magic_vector,
            magic_matrix=magic_matrix,
            # kept only where they sum over the raw targets (regression),
            # so that model.update() can fold new rows in; the Laplace
            # families' statistics sum over latent targets
            u1=ppa._host64(u1) if self._keeps_update_statistics else None,
            u2=ppa._host64(u2) if self._keeps_update_statistics else None,
            device=str(device),
        )

    @staticmethod
    def _probeable_stack(data: Optional[ExpertData]) -> bool:
        """Whether the fitted stack can be probed for post-fit telemetry
        (the JAX package's gate; the port's stacks are all process-local)."""
        return data is not None

    #: per-expert rows the journal keeps (bounded for E in the thousands)
    _EXPERT_QUALITY_CAP = 512

    def _emit_expert_quality(self, instr: Instrumentation, kernel: Kernel, theta,
                             data: Optional[ExpertData]) -> None:
        """Fit-time per-expert quality telemetry, the fit-side leg of the
        statistical quality plane (``obs/quality.py``; JAX
        ``_emit_expert_quality``): every expert's marginal NLL at theta*
        in ONE batched pass with no gradient
        (``resilience/quarantine.expert_nll``: one K1 launch on the card's
        exact lane, no ``[E, s, s]`` stack on the matfree lane), the
        per-expert jitter the recovery settled on, and the aggregation
        weight each expert entered the objective with (``instr.agg_weights``
        when selection ran, else the uniform renormalization).  Stamped as
        ``instr.expert_quality`` (the run journal's ``expert_quality``) with
        the four ``expert_quality.*`` spread metrics, and the probe's
        kernel launches as ``expert_quality.probe_launches.<kernel>``.  A
        multi-head stack probes head 0.  ``GP_EXPERT_TELEMETRY=0``
        disables it; a failure is logged and never fails the fit."""
        if instr is None or not self._probeable_stack(data):
            return
        if os.environ.get("GP_EXPERT_TELEMETRY", "").strip().lower() in ("0", "off", "false"):
            return
        try:
            from spark_gp_tpu_torch.ops import lane_gram, slq_quadrature, spd_linalg
            from spark_gp_tpu_torch.ops import streamed_matvec as sm
            from spark_gp_tpu_torch.resilience.quarantine import PROBE_LAUNCHES, expert_nll

            wrappers = {"spd_inv_logdet": spd_linalg.spd_inv_logdet,
                        "streamed_matvec": sm.streamed_matvec,
                        "streamed_matvec_vjp": sm.streamed_matvec_vjp,
                        "slq_quadrature": slq_quadrature.slq_quadrature,
                        "lane_gram": lane_gram.lane_gram}
            before = {name: w.launches for name, w in wrappers.items()}
            y = data.y if data.y.ndim == 2 else data.y[..., 0]
            probe = ExpertData(x=data.x, y=y, mask=data.mask)
            jitter = instr.expert_jitter
            nll = expert_nll(kernel, theta, probe, jitter=jitter)
            for name, w in wrappers.items():
                if w.launches != before[name]:
                    n = float(w.launches - before[name])
                    instr.log_metric(f"expert_quality.probe_launches.{name}", n)
                    PROBE_LAUNCHES[name] = PROBE_LAUNCHES.get(name, 0.0) + n
            active = data.mask.sum(dim=1).cpu().numpy() > 0
            renorm = float(instr.metrics.get("bcm_renorm", 1.0))
            agg_w = instr.agg_weights
            if agg_w is not None and np.asarray(agg_w).shape[0] == len(active):
                weights = np.asarray(agg_w, dtype=np.float64)
            else:
                weights = np.where(active, renorm, 0.0)
            jit_arr = (np.zeros(nll.shape[0]) if jitter is None
                       else np.broadcast_to(np.asarray(jitter, dtype=np.float64), nll.shape))
            act_nll = nll[active & np.isfinite(nll)]
            cap = self._EXPERT_QUALITY_CAP
            instr.expert_quality = {
                "objective": "marginal_proxy",
                "experts": int(nll.shape[0]),
                "active": int(active.sum()),
                "nll": [float(v) for v in nll[:cap]],
                "jitter": [float(v) for v in jit_arr[:cap]],
                "weight": [float(v) for v in weights[:cap]],
                "truncated": bool(nll.shape[0] > cap),
            }
            if act_nll.size:
                instr.log_metric("expert_quality.nll_spread",
                                 float(act_nll.max() - act_nll.min()))
                instr.log_metric("expert_quality.nll_std", float(act_nll.std()))
            instr.log_metric("expert_quality.jitter_max", float(jit_arr.max(initial=0.0)))
            instr.log_metric("expert_quality.weight_min",
                             float(weights.min(initial=renorm)) if nll.shape[0] else 0.0)
        except Exception:  # noqa: BLE001 -- telemetry must never fail a fit
            logger.warning("per-expert quality telemetry failed", exc_info=True)

    def _emit_covariate_summary(self, instr: Instrumentation, data: Optional[ExpertData],
                                active64) -> None:
        """The training covariates' summary (per-dim moments and the
        active-set-centroid distance sketch, ``obs/quality.
        summarize_covariates``) stamped as ``instr.covariate_summary``; the
        saved model carries it in ``provenance_json``, so serve scores
        incoming rows for input drift against this fit's training mass.
        ``GP_COVARIATE_SUMMARY=0`` disables it (one host copy of the stack
        a fit is its cost); a failure is logged and never fails the fit."""
        if instr is None or not self._probeable_stack(data):
            return
        if os.environ.get("GP_COVARIATE_SUMMARY", "").strip().lower() in ("0", "off", "false"):
            return
        try:
            from spark_gp_tpu_torch.obs.quality import summarize_covariates

            x = data.x.to(torch.float64).cpu().numpy()
            mask = data.mask.cpu().numpy()
            rows = x.reshape(-1, x.shape[-1])[mask.reshape(-1) > 0]
            instr.covariate_summary = summarize_covariates(rows, active=active64,
                                                           seed=self._seed)
        except Exception:  # noqa: BLE001 -- telemetry must never fail a fit
            logger.warning("covariate summary failed", exc_info=True)

    def _emit_precision_guard(self, instr: Instrumentation, kernel: Kernel, theta,
                              data: Optional[ExpertData]) -> None:
        """The fit-time accuracy check of the precision lanes.

        Stamps the lane (``precision_lane``) on every fit.  At a non-strict
        lane it evaluates the objective and its gradient through the
        lane's gram (``likelihood.guard_probe_value_and_grad``: the gram
        at the lane, the linear algebra in float64) on the first expert,
        at the fitted lane and at strict, and records the relative deltas
        ``mixed_precision_guard.delta_{nll,grad}_rel``, ``.delta_predict_rel``
        (0: the predict is float64, which no lane reaches) and
        ``.breach`` (1 where the worst exceeds ``GUARD_BARS[lane]`` or is
        not finite).  A breach warns; under ``GP_GUARD_ACTION=degrade`` it
        raises ``GuardBreachError`` into the degradation ladder, whose
        ``strict_lane`` rung re-runs the fit on the strict lane.  A
        multiclass stack probes its first latent head."""
        from spark_gp_tpu_torch.models.likelihood import guard_probe_value_and_grad
        from spark_gp_tpu_torch.ops import precision

        lane = precision.active_lane()
        instr.metrics["precision_lane"] = lane
        # an earlier attempt's guard (the breach the strict_lane rung
        # re-runs) is not this fit's
        for key in [k for k in instr.metrics if k.startswith("mixed_precision_guard.")]:
            del instr.metrics[key]
        if lane == "strict" or data is None:
            return
        x_p, mask_p = data.x[:1], data.mask[:1]
        y_p = data.y[:1] if data.y.ndim == 2 else data.y[:1, :, 0]
        theta_p = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=data.x.dtype,
                                  device=data.x.device)

        def probe(lane_name):
            nll, grad = guard_probe_value_and_grad(kernel, theta_p, x_p, y_p, mask_p,
                                                   lane=lane_name)
            host = torch.cat([nll.reshape(1), grad.reshape(-1)]).cpu().numpy()
            return float(host[0]), host[1:]

        nll_s, grad_s = probe("strict")
        nll_l, grad_l = probe(lane)

        def rel(delta, scale):
            return float(delta / max(scale, 1e-30))

        # each leg's scale is floored at the probe's row count (the JAX
        # package's floor: a per-point NLL term is O(1)), so a near-zero
        # strict value cannot turn a healthy O(eps) delta into a breach
        nll_scale = max(abs(nll_s), float(mask_p.to(torch.float64).sum()), 1.0)
        d_nll = rel(abs(nll_l - nll_s), nll_scale)
        d_grad = rel(float(np.max(np.abs(grad_l - grad_s), initial=0.0)),
                     max(float(np.max(np.abs(grad_s), initial=0.0)), nll_scale))
        instr.log_metric("mixed_precision_guard.delta_nll_rel", d_nll)
        instr.log_metric("mixed_precision_guard.delta_grad_rel", d_grad)
        # predict runs in float64 (``ProjectedProcessRawPredictor._predict_block``),
        # which no lane reaches
        instr.log_metric("mixed_precision_guard.delta_predict_rel", 0.0)
        bar = precision.GUARD_BARS.get(lane, 1e-3)
        worst = float(np.max([d_nll, d_grad]))  # NaN propagates: a NaN leg breaches
        if self._mesh_of_ranks():
            # each rank probes its own first expert: the worst over the ranks
            # decides, so every rank takes the same rung
            worst = float(self._mesh.all_reduce_host(
                [worst if np.isfinite(worst) else np.inf], "max")[0])
        breach = float(not np.isfinite(worst) or worst > bar)
        instr.log_metric("mixed_precision_guard.breach", breach)
        if breach:
            instr.log_warning(
                f"mixed_precision_guard: lane {lane!r} deviates from the strict lane "
                f"beyond its bar ({worst:.3e} > {bar:.1e}) on the probe expert -- this "
                "kernel/data combination should run on the strict lane "
                "(setPrecisionLane('strict'))"
            )
            from spark_gp_tpu_torch.resilience import fallback

            if precision.guard_action() == "degrade" and fallback.enabled():
                raise fallback.GuardBreachError(lane, worst, bar)

    def _emit_solver_stats(self, metrics: dict, kernel: Kernel, theta,
                           data: ExpertData) -> None:
        """The solver lane's fit-time record, into ``metrics``, for every
        estimator and optimizer (the latent families pass their PPA
        targets as ``data.y``).

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
        # a multiclass stack probes its first latent head, as the JAX package
        y_p = (data.y[:probe] if data.y.ndim == 2 else data.y[:probe, :, 0]) * mask_p
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
