"""GP count regression by the Laplace approximation (log link), the port of
the JAX package's ``models/gp_poisson.py``.

``y_i | f_i ~ Poisson(exp(f_i))`` (or Negative Binomial) with a GP prior
on the log-rate ``f``.  The fit is the generic-likelihood Laplace core
(``models/laplace_generic.py``) under the same expert split and PPA model
as every estimator: host L-BFGS-B from zero latents (the latent modes
warm-start every evaluation, the gram cache serves each), the modes at
theta* as the PPA targets; under ``setOptimizer("device")`` the whole
optimization runs on the device (``models/laplace_device.py``).  The
model predicts the log-rate posterior and ``E[exp(f*)] = exp(mu + var /
2)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.models import laplace_generic as lg
from spark_gp_tpu_torch.models.common import GaussianProcessCommons
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.parallel.experts import ExpertData, num_experts_for, ungroup
from spark_gp_tpu_torch.utils.device import resolve_device
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation, maybe_profile


class GaussianProcessPoissonRegression(GaussianProcessCommons):
    """Count-data GP with the reference's fluent parameter API; targets are
    non-negative integer counts."""

    _likelihood = lg.PoissonLikelihood()

    def fit(self, x, y) -> "GaussianProcessPoissonModel":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y)
        if x.ndim != 2:
            raise ValueError(f"x must be [N, p], got shape {x.shape}")
        if y.shape != (x.shape[0],):
            raise ValueError(f"y must be [N], got shape {y.shape}")
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0) or not np.all(y == np.floor(y)):
            raise ValueError("targets must be non-negative integer counts")
        device = resolve_device(self._device)
        # the NB subclass logs and reports under its own name
        instr = Instrumentation(name=type(self).__name__)
        return self._observed_fit(instr, lambda: self._fit_body(instr, x, y, device))

    def _fit_body(self, instr, x, y, device) -> "GaussianProcessPoissonModel":
        from spark_gp_tpu_torch.resilience import fallback

        with instr.phase("group_experts"):
            data = self._group_screened(instr, x, y, device)
        kernel = self._get_kernel()
        x_prov, n_orig, row_filter = self._provider_rows_filter(x)
        n_experts = num_experts_for(n_orig, self._dataset_size_for_expert)

        def targets_of(latent):
            # every rank's log-rates (over a mesh), in point order
            return row_filter(ungroup(self._gathered_stack(latent, n_experts), n_orig))

        def attempt():
            data_a, cache = self._attempt_operands(kernel, data)
            return self._latent_fit_with_restarts(
                instr, self._stack_fit_once(data_a, cache, x_prov, targets_of))

        model = fallback.run_fit_ladder(self, instr, attempt, data=data)
        model.metrics.update(self._phase_metrics(model.instr))
        return model

    def fit_distributed(self, data, active_set=None) -> "GaussianProcessPoissonModel":
        """The fit from this rank's block of a global stack of counts
        (``parallel/distributed.distribute_global_experts``): the generic
        Laplace objective all-reduced, the log-rate modes on their rank,
        the provider selecting over them off the stack."""
        def prepare(instr, active64, data):
            real = data.mask > 0
            bad = float(torch.sum(real & ((data.y < 0) | (data.y != torch.floor(data.y)))))
            if self._mesh is not None:
                bad = float(self._mesh.all_reduce_host([bad])[0])
            if bad:
                raise ValueError("targets must be non-negative integer counts")
            data_a, cache = self._attempt_operands(self._get_kernel(), data)
            return self._stack_fit_once(data_a, cache, None, None, active64)

        model = self._run_fit_distributed(type(self).__name__, data, active_set, prepare)
        model.metrics.update(self._phase_metrics(model.instr))
        return model

    def _stack_fit_once(self, data_a: ExpertData, cache, x_prov, targets_of, active=None):
        """``fit_once(kernel, instr)`` over the stack ``data_a`` (this
        rank's block under a mesh): the fit, then the PPA model over the
        latent log-rates (GPClf.scala:62-65).  ``x_prov`` None selects the
        active set off the latent stack."""
        lik = self._likelihood

        def fit_once(kernel_r, instr_r):
            with maybe_profile(self._profile_dir, instr_r.name):
                with self._optimize_phase(instr_r, data_a):
                    res, f_final, engine = self._fit_latent(kernel_r, data_a, cache)
                latent = f_final * data_a.mask
                latent_stack = ExpertData(x=data_a.x, y=latent, mask=data_a.mask)
                raw = self._projected_process(
                    instr_r, kernel_r, res.theta, x_prov,
                    None if x_prov is None else targets_of(latent), latent_stack, active)
            model = GaussianProcessPoissonModel(raw)
            model.instr = instr_r
            model.metrics = instr_r.metrics
            model.metrics.update({
                "num_experts": data_a.num_experts * (1 if self._mesh is None
                                                     else self._mesh.world_size),
                "expert_size": data_a.expert_size,
                "likelihood": type(lik).__name__,
                "lbfgs_iters": res.nit,
                "lbfgs_nfev": res.nfev,
                "final_nll": res.fun,
                **engine,
                "gram_cache_engaged": float(cache is not None),
            })
            self._log_renormalized_nll(model.metrics)
            self._emit_solver_stats(model.metrics, kernel_r, res.theta, latent_stack)
            self._emit_aggregation_stats(model.metrics, data_a)
            return model

        return fit_once

    _latent_heads = 1

    def _fit_latent(self, kernel, data: ExpertData, cache):
        """``(OptimizeResult, the latent log-rate modes [E, s], the
        engine's metrics)``: host L-BFGS-B on the summed ``-log Z`` (the
        modes warm-start every evaluation and are settled at theta*), or
        under ``setOptimizer("device")`` the device fit
        (``laplace_generic.fit_generic_device*``; its state file is keyed
        by the likelihood, the JAX package's tag)."""
        lik = self._likelihood
        if self._resolved_optimizer() == "device":
            import hashlib

            lanes = lg.GenericLaplaceLanes(lik, kernel, data.x, data.y, data.mask, self._tol,
                                           cache)
            digest = hashlib.sha1(repr((type(lik).__name__, lik._spec())).encode()).hexdigest()
            return self._latent_device_fit(kernel, data, lanes, lg.segment_kind(lik),
                                           f"generic-{type(lik).__name__}-{digest[:10]}")
        iterations = lg.laplace_generic_mode.iterations
        calls = lg.batched_neg_logz_generic.calls
        objective = lg.make_generic_objective(
            lik, kernel, data.x, data.y, data.mask, self._tol, cache)
        res, f_final = self._optimize_latent_host(kernel, objective, torch.zeros_like(data.y))
        return res, f_final, {
            "newton_iterations": lg.laplace_generic_mode.iterations - iterations,
            "objective_calls": lg.batched_neg_logz_generic.calls - calls,
            **self._resumed_metric(res),
        }


class GaussianProcessNegativeBinomialRegression(GaussianProcessPoissonRegression):
    """Overdispersed count regression, ``y | f ~ NB(exp(f), r)`` (``Var =
    mean + mean^2 / r``): the Poisson estimator's pipeline with
    :class:`~spark_gp_tpu_torch.models.laplace_generic.NegativeBinomialLikelihood`."""

    def __init__(self, dispersion: float = 10.0, device=None) -> None:
        super().__init__(device)
        self.setDispersion(dispersion)

    def setDispersion(self, dispersion: float):
        self._likelihood = lg.NegativeBinomialLikelihood(dispersion)
        return self

    set_dispersion = setDispersion

    def getDispersion(self) -> float:
        return self._likelihood.dispersion


class GaussianProcessPoissonModel:
    """Log-link rate model over the PPA latent posterior."""

    def __init__(self, raw_predictor: ProjectedProcessRawPredictor):
        self.raw_predictor = raw_predictor
        self.metrics: Optional[dict] = None
        #: the fit's Instrumentation, run journal and ladder history
        self.instr = None
        self.run_journal: Optional[dict] = None
        self.degradations: list = []

    def predict_latent(self, x_test):
        """``(mean, var)`` of the log-rate posterior (``var`` is None on
        mean-only models)."""
        mean, var = self.raw_predictor(x_test)
        return mean.cpu().numpy(), (None if var is None else var.cpu().numpy())

    def predict_rate(self, x_test) -> np.ndarray:
        """The posterior-expected rate ``exp(mu + max(var, 0) / 2)``; the MAP
        rate ``exp(mu)`` on mean-only models."""
        mean, var = self.predict_latent(x_test)
        if var is None:
            return np.exp(mean)
        return np.exp(mean + 0.5 * np.maximum(var, 0.0))

    def predict(self, x_test) -> np.ndarray:
        """:meth:`predict_rate`, the natural point prediction."""
        return self.predict_rate(x_test)

    def save(self, path: str) -> None:
        """Write the model in the JAX package's ``.npz`` format, with its
        sha256 sidecar (``utils/serialization.py``)."""
        from spark_gp_tpu_torch.utils.serialization import save_model

        save_model(path, self, kind="poisson")

    @staticmethod
    def load(path: str, device=None) -> "GaussianProcessPoissonModel":
        """A model saved by either package, predicting on ``device``
        (``None`` means ``cuda``)."""
        from spark_gp_tpu_torch.utils.serialization import load_as

        return load_as(path, GaussianProcessPoissonModel, device)
