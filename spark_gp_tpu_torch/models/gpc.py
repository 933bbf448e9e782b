"""Gaussian Process classification (binary, sigmoid link) by the Laplace
approximation -- the counterpart of the reference's
GaussianProcessClassifier.

``fit`` (GPClf.scala:48-66) checks that the labels are 0 or 1, groups the
points into experts with a zero latent vector each (the data screen
quarantines experts with non-finite rows), builds the gram
cache once (``kernels/base.py``), runs host L-BFGS-B on
the summed Laplace ``-log Z`` (``models/laplace.py``; the latent modes
warm-start every evaluation), settles the modes with one last evaluation
at theta*, and builds the Projected Process model with the latent modes
as its regression targets.

The model (GPClf.scala:137-162) predicts the latent mean ``f*`` through
the PPA predictor: ``predict_raw = (-f*, f*)``, ``predict_proba`` the
sigmoid of ``f*`` or, with ``averaged=True``, its expectation under the
latent Gaussian by 32-point Gauss-Hermite quadrature, and ``predict`` the
sign.  Binary only, as in the reference; ``utils.validation.OneVsRest``
reduces a multiclass problem to it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.models import laplace
from spark_gp_tpu_torch.models.common import GaussianProcessCommons, _not_ported
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.ops.integrator import Integrator
from spark_gp_tpu_torch.parallel.experts import ExpertData, ungroup
from spark_gp_tpu_torch.utils.device import resolve_device
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation, maybe_profile


class GaussianProcessClassifier(GaussianProcessCommons):
    """Binary GP classifier with the reference's fluent API:

    >>> gp = (GaussianProcessClassifier(device="cpu")
    ...       .setKernel(lambda: RBFKernel(10.0))
    ...       .setDatasetSizeForExpert(100)
    ...       .setActiveSetSize(100)
    ...       .setTol(1e-3))
    >>> model = gp.fit(x, y)          # y in {0, 1}
    >>> proba = model.predict_proba(x_test)
    """

    def fit(self, x, y) -> "GaussianProcessClassificationModel":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"x must be [N, p], got shape {x.shape}")
        if y.shape != (x.shape[0],):
            raise ValueError(f"y must be [N], got shape {y.shape}")
        if not np.all(np.isin(y, (0.0, 1.0))):
            raise ValueError("Only 0 and 1 labels are supported.")
        device = resolve_device(self._device)
        # the EP subclass logs and reports under its own name
        instr = Instrumentation(name=type(self).__name__)
        return self._observed_fit(instr, lambda: self._fit_body(instr, x, y, device))

    def _fit_body(self, instr, x, y, device) -> "GaussianProcessClassificationModel":
        from spark_gp_tpu_torch.resilience import fallback

        with instr.phase("group_experts"):
            data = self._group_screened(instr, x, y, device)
        kernel = self._get_kernel()
        # the latent targets replace the labels in the PPA build, and the
        # active-set provider sees them too (GPClf.scala:62-65); it gets
        # only the finite rows, and their targets
        x_prov, n_orig, row_filter = self._provider_rows_filter(x)

        def attempt():
            data_a, cache = self._attempt_operands(kernel, data)
            with maybe_profile(self._profile_dir, instr.name):
                with self._optimize_phase(instr, data_a):
                    res, latent, engine_metrics = self._fit_latent(kernel, data_a, cache)
                raw = self._projected_process(
                    instr, kernel, res.theta, x_prov,
                    row_filter(ungroup(latent.cpu().numpy(), n_orig)),
                    ExpertData(x=data_a.x, y=latent, mask=data_a.mask),
                )
            model = self._make_model(raw)
            model.instr = instr
            model.metrics = instr.metrics
            model.metrics.update({
                "num_experts": data.num_experts,
                "expert_size": data.expert_size,
                "solver_lane": it_ops.resolve_for(data_a),
                "lbfgs_iters": res.nit,
                "lbfgs_nfev": res.nfev,
                "final_nll": res.fun,
                **engine_metrics,
                "gram_cache_engaged": float(cache is not None),
            })
            self._log_renormalized_nll(model.metrics)
            self._emit_aggregation_stats(model.metrics, data_a)
            return model

        model = fallback.run_fit_ladder(self, instr, attempt, data=data)
        model.metrics.update(self._phase_metrics(instr))
        return model

    def _fit_latent(self, kernel, data: ExpertData, cache):
        """The inference engine's part of the fit: ``(OptimizeResult, the
        latent PPA targets [E, s], the engine's metrics)``.  Laplace: host
        L-BFGS-B on the summed ``-log Z`` (the latent modes warm-start
        every evaluation), the modes as the targets."""
        iterations = laplace.laplace_mode_batch.iterations
        calls = laplace.batched_neg_logz.calls
        objective = laplace.make_laplace_objective(kernel, data, self._tol, cache)
        res, f_final = self._optimize_latent_host(kernel, objective, torch.zeros_like(data.y))
        return res, f_final * data.mask, {
            "newton_iterations": laplace.laplace_mode_batch.iterations - iterations,
            "objective_calls": laplace.batched_neg_logz.calls - calls,
        }

    def _make_model(self, raw):
        return GaussianProcessClassificationModel(raw)

    def fit_distributed(self, data, active_set=None):
        raise _not_ported("the multi-host classifier fit", 6)


class GaussianProcessClassificationModel:
    """Sigmoid link on the PPA latent mean (GPClf.scala:137-162)."""

    num_classes = 2

    def __init__(self, raw_predictor: ProjectedProcessRawPredictor):
        self.raw_predictor = raw_predictor
        self.metrics: Optional[dict] = None
        #: the fit's Instrumentation, run journal and ladder history
        self.instr = None
        self.run_journal: Optional[dict] = None
        self.degradations: list = []
        self._integrator = None

    def _latent_mean(self, x_test) -> np.ndarray:
        return self.raw_predictor.predict_mean(x_test).cpu().numpy()

    def predict_raw(self, x_test) -> np.ndarray:
        """``[t, 2]`` of ``(-f, f)`` (GPClf.scala:153-156)."""
        f = self._latent_mean(x_test)
        return np.stack([-f, f], axis=1)

    def predict_proba(self, x_test, averaged: bool = False) -> np.ndarray:
        """``[t, 2]`` class probabilities: the sigmoid of the latent mean
        (``averaged=False``, the reference's), or ``E[sigmoid(f)]`` under
        the latent Gaussian by 32-point Gauss-Hermite quadrature on the
        predictive variance (``averaged=True``)."""
        if not averaged:
            p1 = 1.0 / (1.0 + np.exp(-self._latent_mean(x_test)))
            return np.stack([1.0 - p1, p1], axis=1)
        f, var = self.raw_predictor(x_test)
        if var is None:
            raise ValueError(
                "model was fitted with setPredictiveVariance(False); "
                "averaged probabilities need the latent variance -- use "
                "averaged=False or refit with variances enabled"
            )
        if self._integrator is None:
            self._integrator = Integrator(32)
        p1 = self._integrator.expected_of_function_of_normal(
            f, torch.clamp_min(var, 0.0), torch.sigmoid
        ).cpu().numpy()
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, x_test) -> np.ndarray:
        """Labels ``{0, 1}`` from the sign of the latent mean."""
        return (self._latent_mean(x_test) > 0.0).astype(np.float64)

    def save(self, path: str) -> None:
        """Write the model in the JAX package's ``.npz`` format, with its
        sha256 sidecar (``utils/serialization.py``)."""
        from spark_gp_tpu_torch.utils.serialization import save_model

        save_model(path, self, kind="classification")

    @staticmethod
    def load(path: str, device=None) -> "GaussianProcessClassificationModel":
        """A model saved by either package, predicting on ``device``
        (``None`` means ``cuda``)."""
        from spark_gp_tpu_torch.utils.serialization import load_as

        return load_as(path, GaussianProcessClassificationModel, device)
