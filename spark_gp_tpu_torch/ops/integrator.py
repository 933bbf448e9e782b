"""Gauss-Hermite expectation of a function of a normal variable.

    E[f(X)], X ~ N(mu, s^2)  =  (1/sqrt(pi)) * sum_i w_i f(sqrt(2) s x_i + mu)

Nodes and weights come from numpy once, on the host; the expectation is a
weighted sum over tensors of any batch shape.  The classifier's
``predict_proba(..., averaged=True)`` integrates the sigmoid over the
latent Gaussian with it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Integrator:
    """n-point Gauss-Hermite quadrature with precomputed nodes."""

    def __init__(self, n_points: int):
        self.nodes, self.weights = np.polynomial.hermite.hermgauss(n_points)

    def expected_of_function_of_normal(self, mean, variance, f) -> torch.Tensor:
        """``E[f(X)]`` for ``X ~ N(mean, variance)``.

        ``mean``/``variance`` are tensors (or numbers) that broadcast; the
        quadrature axis is appended and summed away in their dtype, on
        their device."""
        mean = torch.as_tensor(mean)
        variance = torch.as_tensor(variance, dtype=mean.dtype, device=mean.device)
        nodes = torch.as_tensor(self.nodes, dtype=mean.dtype, device=mean.device)
        weights = torch.as_tensor(self.weights, dtype=mean.dtype, device=mean.device)
        x = math.sqrt(2.0) * torch.sqrt(variance)[..., None] * nodes + mean[..., None]
        return torch.sum(weights * f(x), dim=-1) / math.sqrt(math.pi)
