"""Binary GP classification by Expectation Propagation (probit link), the
port of the JAX package's ``models/gpc_ep.py`` (host optimizer).

The estimator is :class:`GaussianProcessClassifier` with another inference
engine (``models/ep.py``): the same API, expert split and PPA model, with
EP's posterior latent means as the regression targets.  The fit starts
from zero sites, runs host L-BFGS-B on the summed ``-log Z_EP`` (the sites
warm-start every evaluation), and takes the latent mean at theta*.  EP's
sweeps have no cached-gram path, so the fit builds no gram cache.

The model's probit posterior predictive is closed form:
``p(y = 1 | x) = Phi(mu / sqrt(1 + var))`` (``averaged=True``), else
``Phi(mu)``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtr

from spark_gp_tpu_torch.models import ep
from spark_gp_tpu_torch.models.gpc import (
    GaussianProcessClassificationModel,
    GaussianProcessClassifier,
)
from spark_gp_tpu_torch.parallel.experts import ExpertData


class GaussianProcessEPClassifier(GaussianProcessClassifier):
    """Binary classifier with the EP inference engine; labels 0 or 1."""

    #: EP's device fit (its aux is the site pair) is ROADMAP.md item 4b
    _device_fit_ported = False

    def _gram_cache(self, kernel, data: ExpertData):
        """None: the site sweeps have no cached-gram path, so no cache is
        built (``gram_cache_engaged`` is 0)."""
        return None

    def _fit_latent(self, kernel, data: ExpertData, cache):
        sweeps, calls = ep.ep_fit_sites.sweeps, ep.batched_neg_logz_ep.calls
        objective = ep.make_ep_objective(kernel, data, self._tol)
        res, (tau, nu) = self._optimize_latent_host(
            kernel, objective, (torch.zeros_like(data.y), torch.zeros_like(data.y))
        )
        theta = torch.as_tensor(res.theta, dtype=data.x.dtype, device=data.x.device)
        latent = ep.ep_posterior_mean(kernel, theta, data.x, data.mask, tau, nu)
        return res, latent, {
            "ep_sweeps": ep.ep_fit_sites.sweeps - sweeps,
            "objective_calls": ep.batched_neg_logz_ep.calls - calls,
        }

    def _make_model(self, raw):
        return GaussianProcessEPClassificationModel(raw)


class GaussianProcessEPClassificationModel(GaussianProcessClassificationModel):
    """Probit head over the PPA latent posterior."""

    def predict_proba(self, x_test, averaged: bool = False) -> np.ndarray:
        """``[t, 2]`` class probabilities: ``Phi(mu)`` of the latent mean,
        or with ``averaged=True`` its expectation under the latent
        Gaussian, ``Phi(mu / sqrt(1 + var))``."""
        if averaged:
            f, var = self.raw_predictor(x_test)
            if var is None:
                raise ValueError(
                    "model was fitted with setPredictiveVariance(False); "
                    "averaged probabilities need the latent variance — use "
                    "averaged=False or refit with variances enabled"
                )
            f, var = f.cpu().numpy(), var.cpu().numpy()
            p1 = ndtr(f / np.sqrt(1.0 + np.maximum(var, 0.0)))
        else:
            p1 = ndtr(self._latent_mean(x_test))
        return np.stack([1.0 - p1, p1], axis=1)

    def save(self, path: str) -> None:
        """Write the model with its own ``kind``, so that a round trip
        keeps the probit head (``utils/serialization.py``)."""
        from spark_gp_tpu_torch.utils.serialization import save_model

        save_model(path, self, kind="ep_classification")

    @staticmethod
    def load(path: str, device=None) -> "GaussianProcessEPClassificationModel":
        """An EP model saved by either package, predicting on ``device``
        (``None`` means ``cuda``)."""
        from spark_gp_tpu_torch.utils.serialization import load_as

        return load_as(path, GaussianProcessEPClassificationModel, device)
