"""Native multiclass GP classification (softmax Laplace), the port of the
JAX package's ``models/gpc_mc.py`` (host-optimizer fit).

One model with C coupled latent functions under the softmax link
(``models/laplace_mc.py``), in place of C independent one-vs-rest binary
fits: the probabilities sum to one by construction, and the per-class
factorizations of a Newton step batch into one ``[E * C, s, s]`` pass.

``fit`` checks that the labels are integers ``0 .. C-1`` (C from the
largest label, at least 2), groups the points into experts with a
one-hot target stack ``[E, s, C]`` (padded rows all zero), builds the
gram cache once (``kernels/base.py``), runs host L-BFGS-B on the summed
``-log Z`` with the latent ``[E, s, C]`` stack warm-starting every
evaluation, settles the latents with one last evaluation at theta*, and
builds the Projected Process model over the per-class latents: one
active set, one U1 and one magic matrix shared by the classes, a magic
vector ``[m, C]``.  The active-set provider sees each point's strongest
class latent as its target.

Not ported here: the on-device, sharded, checkpointed and multi-start
fits (ROADMAP.md queue 1, items 4, 6, 7 and 5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_gp_tpu_torch.models import laplace_mc
from spark_gp_tpu_torch.models.common import GaussianProcessCommons
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.parallel.experts import ExpertData, num_experts_for, ungroup
from spark_gp_tpu_torch.utils.device import resolve_device
from spark_gp_tpu_torch.utils.instrumentation import Instrumentation, maybe_profile


def _one_hot_masked(y, mask, n_classes: int):
    """One-hot targets ``[E, s, C]`` of the label stack; padded rows all
    zero."""
    one_hot = torch.nn.functional.one_hot(y.to(torch.int64), n_classes)
    return one_hot.to(mask.dtype) * mask[..., None]


def _validated_labels(x, y):
    """``(x float64, integer labels, C)``, or ``ValueError`` for shapes or
    labels that are not integers ``0 .. C-1`` with ``C >= 2``."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y)
    if x.ndim != 2:
        raise ValueError(f"x must be [N, p], got shape {x.shape}")
    if y.shape != (x.shape[0],):
        raise ValueError(f"y must be [N], got shape {y.shape}")
    y64 = np.asarray(y, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        y_int = y64.astype(np.int64)
    if not np.all(y_int == y64) or y_int.min() < 0:
        raise ValueError("labels must be integers 0 .. C-1")
    n_classes = int(y_int.max()) + 1
    if n_classes < 2:
        raise ValueError("need at least 2 classes")
    return x, y_int, n_classes


class GaussianProcessMulticlassClassifier(GaussianProcessCommons):
    """C-class GP classifier (softmax Laplace) with the reference's fluent
    API; labels are integers ``0 .. C-1``:

    >>> gp = (GaussianProcessMulticlassClassifier(device="cpu")
    ...       .setDatasetSizeForExpert(20)
    ...       .setActiveSetSize(30))
    >>> model = gp.fit(x, y)
    >>> proba = model.predict_proba(x_test)     # [t, C]
    """

    def fit(self, x, y) -> "GaussianProcessMulticlassModel":
        x, y_int, n_classes = _validated_labels(x, y)
        device = resolve_device(self._device)
        instr = Instrumentation(name=type(self).__name__)
        return self._observed_fit(
            instr, lambda: self._fit_body(instr, x, y_int, n_classes, device))

    def _fit_body(self, instr, x, y_int, n_classes, device) -> "GaussianProcessMulticlassModel":
        from spark_gp_tpu_torch.resilience import fallback

        self._latent_heads = n_classes
        with instr.phase("group_experts"):
            data = self._group_screened(instr, x, y_int.astype(np.float64), device)
        kernel = self._get_kernel()
        x_prov, n_orig, row_filter = self._provider_rows_filter(x)
        n_experts = num_experts_for(n_orig, self._dataset_size_for_expert)

        def targets_of(latents):
            # the provider sees each point's strongest class latent, every
            # rank's (over a mesh) in point order
            margin = torch.max(latents, dim=-1).values
            return row_filter(ungroup(self._gathered_stack(margin, n_experts), n_orig))

        def attempt():
            data_a, cache = self._attempt_operands(kernel, data)
            y1h = _one_hot_masked(data_a.y, data_a.mask, n_classes)
            return self._latent_fit_with_restarts(
                instr, self._stack_fit_once(data_a, y1h, cache, x_prov, targets_of))

        model = fallback.run_fit_ladder(self, instr, attempt, data=data)
        model.metrics.update(self._phase_metrics(model.instr))
        return model

    def fit_distributed(self, data, n_classes=None, active_set=None
                        ) -> "GaussianProcessMulticlassModel":
        """The fit from this rank's block of a global stack of integer labels
        ``0 .. C-1`` (``parallel/distributed.distribute_global_experts``): the
        softmax-Laplace objective all-reduced, the ``[E, s, C]`` modes on
        their rank, the provider selecting off the stack over each point's
        strongest class latent.  ``n_classes`` defaults to the largest label
        over every rank, plus one."""
        def prepare(instr, active64, data):
            real = data.mask > 0
            labels = data.y[real]
            top = float(labels.max()) if labels.numel() else -1.0
            bad = float(torch.sum((labels != torch.round(labels)) | (labels < 0)))
            if self._mesh is not None:
                top = float(self._mesh.all_reduce_host([top], "max")[0])
                bad = float(self._mesh.all_reduce_host([bad])[0])
            n_cls = int(top) + 1 if n_classes is None else int(n_classes)
            if n_cls < 2:
                raise ValueError("need at least 2 classes")
            if bad or top >= n_cls:
                raise ValueError("labels must be integers 0 .. C-1")
            self._latent_heads = n_cls
            instr.metrics["num_classes"] = n_cls
            data_a, cache = self._attempt_operands(self._get_kernel(), data)
            y1h = _one_hot_masked(data_a.y, data_a.mask, n_cls)
            return self._stack_fit_once(data_a, y1h, cache, None, None, active64)

        model = self._run_fit_distributed(type(self).__name__, data, active_set, prepare)
        model.metrics.update(self._phase_metrics(model.instr))
        return model

    def _stack_fit_once(self, data_a: ExpertData, y1h, cache, x_prov, targets_of, active=None):
        """``fit_once(kernel, instr)`` over the stack ``data_a`` (this
        rank's block under a mesh) and its one-hot targets: the fit, then
        the PPA model over the per-class latent modes.  ``x_prov`` None
        selects the active set off the latent stack."""
        n_classes = int(y1h.shape[-1])

        def fit_once(kernel_r, instr_r):
            with maybe_profile(self._profile_dir, instr_r.name):
                with self._optimize_phase(instr_r, data_a):
                    res, f_final, engine = self._fit_latent(kernel_r, data_a, y1h, cache)
                # the per-class latent modes are the PPA targets
                latents = f_final * data_a.mask[..., None]
                latent_stack = ExpertData(x=data_a.x, y=latents, mask=data_a.mask)
                raw = self._projected_process(
                    instr_r, kernel_r, res.theta, x_prov,
                    None if x_prov is None else targets_of(latents), latent_stack, active)
            model = GaussianProcessMulticlassModel(raw)
            model.instr = instr_r
            model.metrics = instr_r.metrics
            model.metrics.update({
                "num_experts": data_a.num_experts * (1 if self._mesh is None
                                                     else self._mesh.world_size),
                "expert_size": data_a.expert_size,
                "num_classes": n_classes,
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

    def _fit_latent(self, kernel, data: ExpertData, y1h, cache):
        """``(OptimizeResult, the latent modes [E, s, C], the engine's
        metrics)``: host L-BFGS-B on the summed ``-log Z`` (the modes
        warm-start every evaluation and are settled at theta*), or under
        ``setOptimizer("device")`` the device fit
        (``laplace_mc.fit_gpc_mc_device*``)."""
        if self._resolved_optimizer() == "device":
            lanes = laplace_mc.MulticlassLaplaceLanes(kernel, data.x, y1h, data.mask, self._tol,
                                                      cache)
            return self._latent_device_fit(kernel, data, lanes, "gpc_mc", "gpc_mc",
                                           num_classes=int(y1h.shape[-1]))
        iterations = laplace_mc.laplace_mc_mode.iterations
        calls = laplace_mc.batched_neg_logz_mc.calls
        objective = laplace_mc.make_mc_objective(kernel, data.x, y1h, data.mask, self._tol, cache)
        res, f_final = self._optimize_latent_host(kernel, objective, torch.zeros_like(y1h))
        return res, f_final, {
            "newton_iterations": laplace_mc.laplace_mc_mode.iterations - iterations,
            "objective_calls": laplace_mc.batched_neg_logz_mc.calls - calls,
            **self._resumed_metric(res),
        }


class GaussianProcessMulticlassModel:
    """Softmax link over the C per-class PPA latent means.  The predictor's
    ``magic_vector`` is ``[m, C]``; the variance operator is shared, so
    every class latent has the same variance at a point."""

    def __init__(self, raw_predictor: ProjectedProcessRawPredictor):
        self.raw_predictor = raw_predictor
        self.metrics: Optional[dict] = None
        #: the fit's Instrumentation, run journal and ladder history
        self.instr = None
        self.run_journal: Optional[dict] = None
        self.degradations: list = []

    @property
    def num_classes(self) -> int:
        return int(np.asarray(self.raw_predictor.magic_vector).shape[1])

    def predict_raw(self, x_test) -> np.ndarray:
        """``[t, C]`` latent class scores (the softmax logits)."""
        return self.raw_predictor.predict_mean(x_test).cpu().numpy()

    def predict_proba(self, x_test, averaged: bool = False, mc_samples: int = 256,
                      seed: int = 0) -> np.ndarray:
        """``[t, C]`` class probabilities: the softmax of the latent means
        (``averaged=False``), or its Monte-Carlo expectation under the
        latent Gaussian (``averaged=True``: ``mc_samples`` draws of
        ``numpy.random.default_rng(seed)``, the JAX package's, in chunks
        of the same size, so both packages see the same draws)."""
        if not averaged:
            f = torch.as_tensor(self.predict_raw(x_test), dtype=torch.float64)
            return torch.softmax(f, dim=-1).numpy()
        f, var = self.raw_predictor(x_test)
        if var is None:
            raise ValueError(
                "model was fitted with setPredictiveVariance(False); "
                "averaged probabilities need the latent variance -- use "
                "averaged=False or refit with variances enabled"
            )
        f = f.cpu().numpy().astype(np.float64)
        sd = np.sqrt(np.maximum(var.cpu().numpy().astype(np.float64), 0.0))[:, None]
        rng = np.random.default_rng(seed)
        chunk = max(1, ProjectedProcessRawPredictor._PREDICT_CHUNK_ELEMS
                    // max(1, mc_samples * f.shape[1]))
        out = np.empty_like(f)
        for start in range(0, f.shape[0], chunk):
            fb, sb = f[start:start + chunk], sd[start:start + chunk]
            eps = rng.standard_normal((mc_samples,) + fb.shape)
            probs = torch.softmax(torch.as_tensor(fb[None] + sb[None] * eps), dim=-1)
            out[start:start + chunk] = torch.mean(probs, dim=0).numpy()
        return out

    def predict(self, x_test) -> np.ndarray:
        """Class labels ``0 .. C-1`` (the largest latent)."""
        return np.argmax(self.predict_raw(x_test), axis=-1).astype(np.float64)

    def save(self, path: str) -> None:
        """Write the model in the JAX package's ``.npz`` format, with its
        sha256 sidecar (``utils/serialization.py``)."""
        from spark_gp_tpu_torch.utils.serialization import save_model

        save_model(path, self, kind="multiclass")

    @staticmethod
    def load(path: str, device=None) -> "GaussianProcessMulticlassModel":
        """A model saved by either package, predicting on ``device``
        (``None`` means ``cuda``)."""
        from spark_gp_tpu_torch.utils.serialization import load_as

        return load_as(path, GaussianProcessMulticlassModel, device)
