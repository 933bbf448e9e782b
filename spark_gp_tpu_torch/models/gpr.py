"""Gaussian Process Regression -- BCM fit + PPA prediction.

``fit`` groups the points into experts, builds the kernel's
theta-invariant gram cache once (``kernels/base.py``; kernels without
one, and the matfree lane, go without), optimizes the noise-augmented
kernel's hyperparameters against the summed per-expert NLL on the solver
lane in effect (``setSolverLane``; autograd gradients, host L-BFGS-B
within the kernel's box bounds), then builds the m-point Projected
Process model.  The fitted model predicts
the posterior mean (``predict``) and variance (``predict_with_var``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from spark_gp_tpu_torch.models.common import GaussianProcessCommons, _not_ported
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.utils.device import resolve_device


class GaussianProcessRegression(GaussianProcessCommons):
    """Estimator with the reference's fluent API:

    >>> gp = (GaussianProcessRegression(device="cpu")
    ...       .setKernel(lambda: 1.0 * RBFKernel(0.1, 1e-6, 10))
    ...       .setDatasetSizeForExpert(100)
    ...       .setActiveSetSize(100)
    ...       .setSigma2(1e-3))
    >>> model = gp.fit(x, y)
    >>> mean = model.predict(x_test)
    """

    def setObjective(self, objective: str) -> "GaussianProcessRegression":
        """Only ``"marginal"`` (the BCM NLL) is ported."""
        if objective not in ("marginal", "loo", "elbo"):
            raise ValueError(
                f"unknown objective {objective!r}; "
                "expected 'marginal', 'loo' or 'elbo'"
            )
        if objective != "marginal":
            raise _not_ported(f"the {objective!r} objective", 8)
        return self

    set_objective = setObjective

    def fit(self, x, y) -> "GaussianProcessRegressionModel":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"x must be [N, p], got shape {x.shape}")
        if y.shape != (x.shape[0],):
            raise ValueError(f"y must be [N], got shape {y.shape}")
        if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
            raise ValueError(
                "x and y must be finite (quarantine of non-finite rows is "
                "not ported yet: ROADMAP.md queue 1, item 2)"
            )
        device = resolve_device(self._device)
        # host wall-clock per phase: each phase ends in a device-to-host
        # copy (the optimizer's per-evaluation fetch, the statistics'
        # fetch), so the clock covers the device work
        clock = [time.perf_counter()]
        data = self._group(x, y, device)
        kernel = self._get_kernel()
        cache = self._gram_cache(kernel, data)
        clock.append(time.perf_counter())
        res = self._optimize_hypers_body(kernel, make_value_and_grad(kernel, data, cache))
        clock.append(time.perf_counter())
        raw = self._projected_process(kernel, res.theta, x, y, data)
        clock.append(time.perf_counter())
        model = GaussianProcessRegressionModel(raw)
        model.metrics = {
            "num_experts": data.num_experts,
            "expert_size": data.expert_size,
            "lbfgs_iters": res.nit,
            "lbfgs_nfev": res.nfev,
            "final_nll": res.fun,
            "gram_cache_engaged": float(cache is not None),
            "group_seconds": clock[1] - clock[0],
            "optimize_seconds": clock[2] - clock[1],
            "ppa_seconds": clock[3] - clock[2],
        }
        self._emit_solver_stats(model.metrics, kernel, res.theta, data)
        return model


class GaussianProcessRegressionModel:
    """Fitted model: posterior mean / variance against the m-point active set."""

    def __init__(self, raw_predictor: ProjectedProcessRawPredictor):
        self.raw_predictor = raw_predictor
        self.metrics: Optional[dict] = None

    def predict(self, x_test) -> np.ndarray:
        return self.raw_predictor.predict_mean(x_test).cpu().numpy()

    def predict_with_var(self, x_test):
        mean, var = self.raw_predictor(x_test)
        if var is None:
            raise ValueError(
                "model was fitted with setPredictiveVariance(False); "
                "use predict(), or refit with variances enabled"
            )
        return mean.cpu().numpy(), var.cpu().numpy()
