"""Gaussian Process Regression -- BCM fit + PPA prediction.

``fit`` groups the points into experts, builds the kernel's
theta-invariant gram cache once (``kernels/base.py``; kernels without
one, the matfree lane and the ELBO go without), optimizes the
noise-augmented kernel's hyperparameters against the objective
``setObjective`` names -- the summed per-expert NLL on the solver lane in
effect (``setSolverLane``), the LOO pseudo-likelihood (``models/loo.py``)
or the Titsias ELBO (``models/sgpr.py``) -- with autograd gradients and
host L-BFGS-B within the kernel's box bounds, from one starting point or
several (``setNumRestarts``), then builds the m-point Projected Process
model.  The data screen quarantines experts with non-finite rows, and a
failed attempt is retried after the per-expert recovery ladder
(``models/common.py``, ``resilience/``).  The fitted model predicts the
posterior mean (``predict``), variance (``predict_with_var``) and joint
covariance (``predict_with_cov``), draws from the joint posterior
(``sample_posterior``) and folds new rows in (``update``); ``loo`` gives
the per-expert leave-one-out diagnostics at a fitted model's theta, and
``poe_predictor`` the product-of-experts predictor (``models/poe.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.models.active_set import GreedilyOptimizingActiveSetProvider
from spark_gp_tpu_torch.models.common import GaussianProcessCommons
from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.ops.linalg import psd_safe_cholesky_np
from spark_gp_tpu_torch.utils.device import resolve_device, working_dtype
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation, maybe_profile


def _check_xy(x, y):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"x must be [N, p], got shape {x.shape}")
    if y.shape != (x.shape[0],):
        raise ValueError(f"y must be [N], got shape {y.shape}")
    return x, y


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

    _restarts_ported = True
    _keeps_update_statistics = True

    def setObjective(self, objective: str) -> "GaussianProcessRegression":
        """``"marginal"`` (the default, the BCM NLL), ``"loo"`` (the LOO log
        pseudo-likelihood, R&W section 5.4.2) or ``"elbo"`` (the Titsias
        collapsed bound, with ``sigma2`` the likelihood noise: the active
        set is selected once, before the optimization, at the kernel's
        initial theta, shared by every restart and reused by the PPA
        build)."""
        if objective not in ("marginal", "loo", "elbo"):
            raise ValueError(
                f"unknown objective {objective!r}; "
                "expected 'marginal', 'loo' or 'elbo'"
            )
        self._objective = objective
        return self

    set_objective = setObjective

    def fit(self, x, y) -> "GaussianProcessRegressionModel":
        x, y = _check_xy(x, y)
        device = resolve_device(self._device)
        instr = Instrumentation(name="GaussianProcessRegression")
        # the observation shell wraps the whole post-validation body, so
        # the grouping and screen land inside the fit's root span
        return self._observed_fit(instr, lambda: self._fit_body(instr, x, y, device))

    def _fit_body(self, instr, x, y, device) -> "GaussianProcessRegressionModel":
        with instr.phase("group_experts"):
            data = self._group_screened(instr, x, y, device)
        # the providers sample raw host rows: hand them only finite ones
        x, y = self._screen_rows(x, y)
        kernel = self._get_kernel()
        if self._objective == "elbo":
            self._check_elbo_provider(kernel)

        def run_fit(data_r, rextra, cache):
            x_r, y_r = x, y
            if data_r is not data:
                # recovery or selection rebuilt the stack: the provider rows
                # come from it (a poisoned row can be finite, and one in the
                # active set would poison the PPA statistics)
                keep = data_r.mask > 0
                x_r = data_r.x[keep].to(torch.float64).cpu().numpy()
                y_r = data_r.y[keep].to(torch.float64).cpu().numpy()
            data_r, rextra, cache = self._host_f64_operands(data_r, rextra, cache)
            with maybe_profile(self._profile_dir, instr.name):
                active, extra = None, (rextra if self._objective == "marginal" else ())
                if self._objective == "elbo":
                    # the bound needs its inducing set before the
                    # optimization, selected from this attempt's rows
                    with instr.phase("active_set"):
                        active = self._select_active(kernel, kernel.init_theta(), x_r, y_r,
                                                     device)
                    extra = (active, self._sigma2)
                    # checkpoint tags carry the bound's surface
                    self._objective_salt = self._elbo_checkpoint_salt(extra)
                vag = make_value_and_grad(kernel, data_r, cache, self._objective, extra)
                with self._optimize_phase(instr, data_r):
                    res, restart_metrics = self._optimize_with_restarts(kernel, vag)
                raw = self._projected_process(instr, kernel, res.theta, x_r, y_r, data_r, active)
            model = GaussianProcessRegressionModel(raw)
            model.instr = instr
            model.metrics = instr.metrics
            model.metrics.update({
                "num_experts": data.num_experts,
                "expert_size": data.expert_size,
                "objective": self._objective,
                "lbfgs_iters": res.nit,
                "lbfgs_nfev": res.nfev,
                "final_nll": res.fun,
                "gram_cache_engaged": float(cache is not None),
                **restart_metrics,
            })
            self._log_renormalized_nll(model.metrics)
            self._emit_solver_stats(model.metrics, kernel, res.theta, data_r)
            self._emit_aggregation_stats(model.metrics, data_r)
            return model

        from spark_gp_tpu_torch.resilience import fallback

        # the degradation ladder wraps the complete attempt, the per-expert
        # recovery inside it: a classified failure (OOM, compile, exhausted
        # numerics) re-runs the fit one rung down (GP_FALLBACK=0: raw)
        model = fallback.run_fit_ladder(
            self, instr, lambda: self._run_with_expert_resilience(instr, data, run_fit),
            data=data)
        model.metrics.update(self._phase_metrics(instr))
        return model

    def _check_elbo_provider(self, kernel) -> None:
        """The greedy provider scores by dividing by the white noise: with
        the ELBO it selects at the initial theta, where a model kernel
        without noise (``setSigma2(0)`` and no noise term) has none."""
        provider = self._active_set_provider
        greedy = provider is GreedilyOptimizingActiveSetProvider or isinstance(
            provider, GreedilyOptimizingActiveSetProvider
        )
        theta0 = torch.as_tensor(kernel.init_theta())
        if greedy and float(kernel.white_noise_var(theta0)) == 0.0:
            raise ValueError(
                "setObjective('elbo') with the greedy provider needs "
                "nonzero white noise (the Seeger scores divide by it); "
                "set a nonzero sigma2, or use the random/k-means provider"
            )

    @staticmethod
    def _elbo_checkpoint_salt(extra) -> str:
        """Digest of the ELBO's objective surface (the inducing set and
        sigma2): two ELBO fits over different surfaces sharing a checkpoint
        directory neither resume from nor overwrite each other."""
        import hashlib

        h = hashlib.sha1()
        for e in extra:
            h.update(np.asarray(e, dtype=np.float64).tobytes())
        return h.hexdigest()[:10]

    def loo(self, x, y, model: "Optional[GaussianProcessRegressionModel]" = None) -> dict:
        """Exact per-expert leave-one-out diagnostics (``models/loo.py``)
        of ``(x, y)`` grouped as this estimator groups them, at ``model``'s
        fitted theta when given, else at the kernel's initial theta; one
        batched inverse on the estimator's device."""
        from spark_gp_tpu_torch.models.loo import loo_diagnostics

        x, y, kernel, theta = self._resolve_eval_inputs(x, y, model)
        device = resolve_device(self._device)
        return loo_diagnostics(kernel, theta, x, y, self._dataset_size_for_expert,
                               working_dtype(device), device)

    def _resolve_eval_inputs(self, x, y, model):
        """Checked ``(x, y)`` with the kernel and theta to evaluate at, for
        ``loo`` and ``poe_predictor``: the model's fitted ones when given,
        else the initial theta."""
        x, y = _check_xy(x, y)
        if model is not None:
            return x, y, model.raw_predictor.kernel, model.raw_predictor.theta
        kernel = self._get_kernel()
        return x, y, kernel, kernel.init_theta()

    def poe_predictor(self, x, y, model: "Optional[GaussianProcessRegressionModel]" = None,
                      mode: Optional[str] = None):
        """Product-of-experts predictor over this estimator's expert split
        (``models/poe.py``), the inducing-set-free alternative to the PPA
        model: each expert answers from its exact s-point posterior and
        the answers combine by precision weighting (``mode``: ``"rbcm"``,
        ``"gpoe"``, ``"bcm"``, ``"poe"`` or ``"healed"``; ``None`` is the
        engaged aggregation policy, else ``"rbcm"``).  At ``model``'s
        fitted theta when given, else the initial theta, on the
        estimator's device."""
        from spark_gp_tpu_torch.models.poe import make_poe_predictor

        x, y, kernel, theta = self._resolve_eval_inputs(x, y, model)
        device = resolve_device(self._device)
        return make_poe_predictor(kernel, theta, x, y, self._dataset_size_for_expert, mode=mode,
                                  dtype=working_dtype(device), device=device)


class GaussianProcessRegressionModel:
    """Fitted model: posterior mean / variance (and the joint covariance
    and posterior draws) against the m-point active set; ``update`` folds
    new rows in without a refit."""

    def __init__(self, raw_predictor: ProjectedProcessRawPredictor):
        self.raw_predictor = raw_predictor
        self.metrics: Optional[dict] = None
        #: the fit's Instrumentation, run journal and ladder history
        self.instr = None
        self.run_journal: Optional[dict] = None
        self.degradations: list = []

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

    def predict_with_cov(self, x_test):
        """``(mean [t], cov [t, t])``: the joint predictive covariance of
        the test points (the reference exposes only the per-point
        variance); ``diag(cov)`` is ``predict_with_var``'s variance up to
        rounding."""
        mean, cov = self.raw_predictor.predict_with_cov(x_test)
        return mean.cpu().numpy(), cov.cpu().numpy()

    def sample_posterior(self, x_test, n_samples: int = 1, seed: int = 0) -> np.ndarray:
        """``[n_samples, t]`` joint draws from the posterior over the test
        points: ``mean + L eps``, with ``L`` the jitter-repaired Cholesky
        of the predictive covariance in float64 on the host and ``eps``
        from numpy's ``default_rng(seed)``, the JAX package's draws."""
        mean, cov = self.predict_with_cov(x_test)
        chol = psd_safe_cholesky_np(np.asarray(cov, dtype=np.float64), "predictive covariance")
        eps = np.random.default_rng(seed).standard_normal((n_samples, mean.shape[0]))
        return mean[None, :] + eps @ chol.T

    def update(self, x_new, y_new) -> "GaussianProcessRegressionModel":
        """A new model with ``(x_new, y_new)`` folded into the PPA
        statistics at the fitted theta and active set, without a refit
        (``ProjectedProcessRawPredictor.with_additional_data``); this
        model is left as it is."""
        return GaussianProcessRegressionModel(self.raw_predictor.with_additional_data(x_new, y_new))

    def save(self, path: str) -> None:
        """Write the model in the JAX package's ``.npz`` format, with its
        sha256 sidecar (``utils/serialization.py``); ``u1`` / ``u2`` go
        with it, so a loaded model still ``update``s."""
        from spark_gp_tpu_torch.utils.serialization import save_model

        save_model(path, self, kind="regression")

    @staticmethod
    def load(path: str, device=None) -> "GaussianProcessRegressionModel":
        """A model saved by either package, predicting on ``device``
        (``None`` means ``cuda``)."""
        from spark_gp_tpu_torch.utils.serialization import load_as

        return load_as(path, GaussianProcessRegressionModel, device)
