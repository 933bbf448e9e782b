"""Model evaluation: RMSE, accuracy, the mean negative log predictive
density, shuffled k-fold cross-validation,
a single train/validation split and the one-vs-rest multiclass reduction
(the counterparts of Spark ML's evaluators, CrossValidator with an empty
grid, TrainValidationSplit and OneVsRest)."""

from __future__ import annotations

import copy

import numpy as np


def rmse(y_true, y_pred) -> float:
    err = np.asarray(y_true) - np.asarray(y_pred)
    return float(np.sqrt(np.mean(err * err)))


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


accuracy.greater_is_better = True


def nlpd(y_true, mean, var) -> float:
    """Mean negative log predictive density under Gaussian predictive
    marginals (R&W eq. 2.34), from ``model.predict_with_var``'s output.
    The variance is floored at 1e-12: a zero predictive variance scores a
    finite (large) penalty, and an exact interpolation at most
    ``log(1e-12)``."""
    y = np.asarray(y_true, dtype=np.float64)
    mu = np.asarray(mean, dtype=np.float64)
    v = np.maximum(np.asarray(var, dtype=np.float64), 1e-12)
    return float(np.mean(0.5 * (np.log(2.0 * np.pi * v) + (y - mu) ** 2 / v)))


def kfold_indices(n: int, num_folds: int, seed: int = 0):
    """Shuffled k-fold split; yields ``(train_idx, test_idx)``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, num_folds)
    for i in range(num_folds):
        test = folds[i]
        train = np.concatenate([folds[j] for j in range(num_folds) if j != i])
        yield train, test


def cross_validate(estimator, x, y, num_folds: int = 10, metric=rmse,
                   seed: int = 0) -> float:
    """Mean ``metric`` over ``num_folds`` folds, each fitted by a shallow
    copy of ``estimator`` on the other folds."""
    x = np.asarray(x)
    y = np.asarray(y)
    scores = []
    for train_idx, test_idx in kfold_indices(x.shape[0], num_folds, seed):
        model = copy.copy(estimator).fit(x[train_idx], y[train_idx])
        scores.append(metric(y[test_idx], model.predict(x[test_idx])))
    return float(np.mean(scores))


def train_validation_split(estimator, x, y, train_ratio: float = 0.8,
                           metric=accuracy, seed: int = 0) -> float:
    """``metric`` on the held-out share after one fit of ``estimator`` on a
    shuffled ``train_ratio`` share (the JAX package's split: the same rows
    for the same seed)."""
    x = np.asarray(x)
    y = np.asarray(y)
    perm = np.random.default_rng(seed).permutation(x.shape[0])
    cut = int(train_ratio * x.shape[0])
    train_idx, test_idx = perm[:cut], perm[cut:]
    model = estimator.fit(x[train_idx], y[train_idx])
    return metric(y[test_idx], model.predict(x[test_idx]))


class OneVsRest:
    """Multiclass reduction over a binary classifier exposing
    ``predict_raw``: one fresh estimator per class, fitted on "this class
    or not"; :meth:`predict` picks the class whose model emits the largest
    raw latent."""

    def __init__(self, classifier_factory):
        """``classifier_factory() -> estimator`` (a fresh one per class)."""
        self.classifier_factory = classifier_factory
        self.models_ = None
        self.classes_ = None

    def fit(self, x, y) -> "OneVsRest":
        x = np.asarray(x)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.models_ = [
            self.classifier_factory().fit(x, (y == cls).astype(np.float64))
            for cls in self.classes_
        ]
        return self

    def _latents(self, x_test) -> np.ndarray:
        return np.stack([m.predict_raw(x_test)[:, 1] for m in self.models_], axis=1)

    def predict(self, x_test) -> np.ndarray:
        return self.classes_[np.argmax(self._latents(x_test), axis=1)]

    def predict_proba(self, x_test) -> np.ndarray:
        """``[t, C]`` per-class sigmoids renormalized to sum to 1, computed
        in log space (a softmax over ``log_sigmoid`` of the latents), so
        saturated sigmoids can neither zero a row nor move its argmax away
        from :meth:`predict`.  Columns follow ``classes_``."""
        from scipy.special import log_expit, softmax

        return softmax(log_expit(self._latents(x_test)), axis=1)
