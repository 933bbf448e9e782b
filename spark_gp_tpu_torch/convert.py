"""Carry a fitted model across from the JAX package.

A GP's state is its hyperparameter vector plus the PPA model built on it:
``theta``, ``active``, ``magic_vector``, ``magic_matrix`` and the additive
statistics ``u1``/``u2``.  Given those arrays (for example the fields of a
JAX model's ``raw_predictor``, as numpy) and a port kernel of the same
expression -- hence the same theta layout -- :func:`predictor_from_fields`
builds the port's predictor, which then computes what the JAX model does;
:func:`classifier_from_fields` wraps it into a binary classification
model and :func:`multiclass_from_fields` (``magic_vector [m, C]``) into a
multiclass one.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from spark_gp_tpu_torch.kernels.base import Kernel
from spark_gp_tpu_torch.models.gpc import GaussianProcessClassificationModel
from spark_gp_tpu_torch.models.gpc_mc import GaussianProcessMulticlassModel
from spark_gp_tpu_torch.models.ppa import ProjectedProcessRawPredictor

FIELDS = ("theta", "active", "magic_vector", "magic_matrix", "u1", "u2")


def predictor_from_fields(
    fields: Mapping, kernel: Kernel, device=None
) -> ProjectedProcessRawPredictor:
    """The port's predictor from a mapping of the :data:`FIELDS` arrays
    (``magic_matrix``, ``u1`` and ``u2`` may be missing or None).  Raises
    ``ValueError`` when theta does not fit ``kernel``."""

    def arr(name):
        value = fields.get(name)
        return None if value is None else np.asarray(value, dtype=np.float64)

    theta = arr("theta").ravel()
    if theta.shape[0] != kernel.n_hypers:
        raise ValueError(
            f"theta has {theta.shape[0]} entries; the kernel has "
            f"{kernel.n_hypers} hyperparameters -- build the port kernel "
            "from the same expression as the fitted model's"
        )
    return ProjectedProcessRawPredictor(
        kernel=kernel,
        theta=theta,
        active=arr("active"),
        magic_vector=arr("magic_vector"),
        magic_matrix=arr("magic_matrix"),
        u1=arr("u1"),
        u2=arr("u2"),
        device=None if device is None else str(device),
    )


def classifier_from_fields(
    fields: Mapping, kernel: Kernel, device=None
) -> GaussianProcessClassificationModel:
    """The port's binary classification model from a JAX classifier's
    ``raw_predictor`` fields (:func:`predictor_from_fields`): the same
    latent mean, hence the same ``predict_raw``, ``predict_proba`` and
    ``predict``."""
    return GaussianProcessClassificationModel(
        predictor_from_fields(fields, kernel, device)
    )


def multiclass_from_fields(
    fields: Mapping, kernel: Kernel, device=None
) -> GaussianProcessMulticlassModel:
    """The port's multiclass model from a JAX multiclass model's
    ``raw_predictor`` fields (:func:`predictor_from_fields`, with the
    ``[m, C]`` magic vector): the same C latent means, hence the same
    ``predict_raw``, ``predict_proba`` and ``predict``.  Raises
    ``ValueError`` when the magic vector is not ``[m, C]``."""
    predictor = predictor_from_fields(fields, kernel, device)
    mv = predictor.magic_vector
    if mv.ndim != 2 or mv.shape[0] != predictor.active.shape[0]:
        raise ValueError(
            f"a multiclass model's magic vector is [m, C]; got {mv.shape} "
            f"for {predictor.active.shape[0]} active points"
        )
    return GaussianProcessMulticlassModel(predictor)
