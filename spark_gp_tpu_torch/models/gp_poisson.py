"""GP count regression by the Laplace approximation (log link), the port of
the JAX package's ``models/gp_poisson.py`` (host optimizer).

``y_i | f_i ~ Poisson(exp(f_i))`` (or Negative Binomial) with a GP prior
on the log-rate ``f``.  The fit is the generic-likelihood Laplace core
(``models/laplace_generic.py``) under the same expert split and PPA model
as every estimator: host L-BFGS-B from zero latents (the latent modes
warm-start every evaluation, the gram cache serves each), the modes at
theta* as the PPA targets.  The model predicts the log-rate posterior and
``E[exp(f*)] = exp(mu + var / 2)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.models import laplace_generic as lg
from spark_gp_tpu_torch.models.common import GaussianProcessCommons, _not_ported
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.parallel.experts import ExpertData, ungroup
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

        lik = self._likelihood
        iterations = lg.laplace_generic_mode.iterations
        calls = lg.batched_neg_logz_generic.calls
        with instr.phase("group_experts"):
            data = self._group_screened(instr, x, y, device)
        kernel = self._get_kernel()
        x_prov, n_orig, row_filter = self._provider_rows_filter(x)

        def attempt():
            data_a, cache = self._attempt_operands(kernel, data)
            with maybe_profile(self._profile_dir, instr.name):
                with self._optimize_phase(instr, data_a):
                    objective = lg.make_generic_objective(lik, kernel, data_a.x, data_a.y,
                                                          data_a.mask, self._tol, cache)
                    res, f_final = self._optimize_latent_host(kernel, objective,
                                                              torch.zeros_like(data_a.y))
                # the latent log-rates replace the counts in the PPA build
                # and as the provider's targets (GPClf.scala:62-65)
                latent = f_final * data_a.mask
                raw = self._projected_process(
                    instr, kernel, res.theta, x_prov,
                    row_filter(ungroup(latent.cpu().numpy(), n_orig)),
                    ExpertData(x=data_a.x, y=latent, mask=data_a.mask),
                )
            model = GaussianProcessPoissonModel(raw)
            model.instr = instr
            model.metrics = instr.metrics
            model.metrics.update({
                "num_experts": data.num_experts,
                "expert_size": data.expert_size,
                "solver_lane": it_ops.resolve_for(data_a),
                "likelihood": type(lik).__name__,
                "lbfgs_iters": res.nit,
                "lbfgs_nfev": res.nfev,
                "final_nll": res.fun,
                "newton_iterations": lg.laplace_generic_mode.iterations - iterations,
                "objective_calls": lg.batched_neg_logz_generic.calls - calls,
                "gram_cache_engaged": float(cache is not None),
            })
            self._log_renormalized_nll(model.metrics)
            self._emit_aggregation_stats(model.metrics, data_a)
            return model

        model = fallback.run_fit_ladder(self, instr, attempt, data=data)
        model.metrics.update(self._phase_metrics(instr))
        return model

    def fit_distributed(self, data, active_set=None):
        raise _not_ported("the multi-host count-regression fit", 6)


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
