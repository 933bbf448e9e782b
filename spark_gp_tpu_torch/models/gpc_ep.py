"""Binary GP classification by Expectation Propagation (probit link), the
port of the JAX package's ``models/gpc_ep.py``.

The estimator is :class:`GaussianProcessClassifier` with another inference
engine (``models/ep.py``): the same API, expert split and PPA model, with
EP's posterior latent means as the regression targets.  The fit starts
from zero sites, runs host L-BFGS-B on the summed ``-log Z_EP`` (the sites
warm-start every evaluation), and takes the latent mean at theta*.  Under
``setOptimizer("device")`` the whole optimization runs on the device, the
site pair its aux carry (``ep.fit_gpc_ep_device``; restarts as one
batched loop), and the latent mean at theta* is computed on the device;
a checkpoint directory sends the fit to the host driver, and the ladder's
``segmented`` rung runs the one-loop device fit, as in the JAX package,
which wires no segmented EP variant.  ``setMesh`` and ``fit_distributed``
(the classifier's) sum the EP objective over the ranks: on the host
optimizer the all-reduced ``ep.make_ep_objective``, on the device one
the sharded device fit (``ep.fit_gpc_ep_device(mesh=)``).  EP's sweeps have
no cached-gram path, so the fit builds no gram cache.

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


    def _gram_cache(self, kernel, data: ExpertData):
        """None: the site sweeps have no cached-gram path, so no cache is
        built (``gram_cache_engaged`` is 0)."""
        return None

    def _fit_latent(self, kernel, data: ExpertData, cache):
        if self._resolved_optimizer() == "device" and self._checkpoint_dir is None:
            return self._ep_device_fit(kernel, data)
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

    def _ep_device_fit(self, kernel, data: ExpertData):
        """The device optimizer's fit, one attempt: ``ep.fit_gpc_ep_device``,
        or ``ep.fit_gpc_ep_device_multistart`` for several restarts, with
        the latent mean at theta* computed on the device; one loop on the
        ladder's ``segmented`` rung too, as the JAX estimator runs it (no
        segmented EP variant).  The results come back in one transfer."""
        dev, lower, upper, log_space = self._device_fit_prelude(kernel, data)
        loop: dict = {}
        multistart = self._use_batched_multistart()
        if multistart:
            theta, latent, f, n_iter, n_fev, stalled, f_all, best = \
                ep.fit_gpc_ep_device_multistart(
                    kernel, self._tol, log_space, dev(self._restart_theta_batch(kernel)), lower,
                    upper, data, self._max_iter, loop_metrics=loop, mesh=self._mesh)
            extra = {"f_all": f_all, "best": best}
        else:
            theta, _, latent, f, n_iter, n_fev, stalled = ep.fit_gpc_ep_device(
                kernel, self._tol, log_space, dev(kernel.init_theta()), lower, upper, data,
                self._max_iter, loop_metrics=loop, mesh=self._mesh)
            extra = {}
        pending = {"theta": theta, "f": f, "n_iter": n_iter, "n_fev": n_fev, "stalled": stalled,
                   **extra}
        res, metrics = self._device_fit_result(self._finalize_device_fit(pending), loop,
                                               multistart)
        metrics.update(ep_sweeps=int(loop.get("newton_iterations", 0)),
                       objective_calls=int(loop.get("gradient_passes", 0)))
        return res, latent, metrics

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
