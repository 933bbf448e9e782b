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
from spark_gp_tpu_torch.models.common import GaussianProcessCommons, _not_ported
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor
from spark_gp_tpu_torch.ops import iterative as it_ops
from spark_gp_tpu_torch.parallel.experts import ExpertData, ungroup
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

        iterations = laplace_mc.laplace_mc_mode.iterations
        calls = laplace_mc.batched_neg_logz_mc.calls
        with instr.phase("group_experts"):
            data = self._group_screened(instr, x, y_int.astype(np.float64), device)
        kernel = self._get_kernel()
        x_prov, n_orig, row_filter = self._provider_rows_filter(x)

        def attempt():
            data_a, cache = self._attempt_operands(kernel, data)
            y1h = _one_hot_masked(data_a.y, data_a.mask, n_classes)
            with maybe_profile(self._profile_dir, instr.name):
                with self._optimize_phase(instr, data_a):
                    objective = laplace_mc.make_mc_objective(
                        kernel, data_a.x, y1h, data_a.mask, self._tol, cache
                    )
                    res, f_final = self._optimize_latent_host(kernel, objective,
                                                              torch.zeros_like(y1h))
                # the per-class latent modes are the PPA targets; the
                # provider sees each point's strongest class latent
                latents = f_final * data_a.mask[..., None]
                margin = torch.max(latents, dim=-1).values.cpu().numpy()
                raw = self._projected_process(
                    instr, kernel, res.theta, x_prov, row_filter(ungroup(margin, n_orig)),
                    ExpertData(x=data_a.x, y=latents, mask=data_a.mask),
                )
            model = GaussianProcessMulticlassModel(raw)
            model.instr = instr
            model.metrics = instr.metrics
            model.metrics.update({
                "num_experts": data.num_experts,
                "expert_size": data.expert_size,
                "num_classes": n_classes,
                "solver_lane": it_ops.resolve_for(data_a),
                "lbfgs_iters": res.nit,
                "lbfgs_nfev": res.nfev,
                "final_nll": res.fun,
                "newton_iterations": laplace_mc.laplace_mc_mode.iterations - iterations,
                "objective_calls": laplace_mc.batched_neg_logz_mc.calls - calls,
                "gram_cache_engaged": float(cache is not None),
            })
            self._log_renormalized_nll(model.metrics)
            self._emit_aggregation_stats(model.metrics, data_a)
            return model

        model = fallback.run_fit_ladder(self, instr, attempt, data=data)
        model.metrics.update(self._phase_metrics(instr))
        return model

    def fit_distributed(self, data, n_classes=None, active_set=None):
        raise _not_ported("the multi-host multiclass fit", 6)


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
