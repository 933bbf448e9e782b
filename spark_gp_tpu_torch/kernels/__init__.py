"""Covariance kernels and the composition DSL (see ``base.py``)."""

from spark_gp_tpu_torch.kernels.base import (
    Const,
    ConstScaleKernel,
    EyeKernel,
    Kernel,
    Scalar,
    StationaryKernel,
    SumKernel,
    TrainableScaleKernel,
    WhiteNoiseKernel,
    supports_matfree,
)
from spark_gp_tpu_torch.kernels.families import (
    DotProductKernel,
    PolynomialKernel,
    RationalQuadraticKernel,
)
from spark_gp_tpu_torch.kernels.matern import (
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
)
from spark_gp_tpu_torch.kernels.rbf import ARDRBFKernel, RBFKernel

__all__ = [
    "Kernel",
    "StationaryKernel",
    "EyeKernel",
    "SumKernel",
    "TrainableScaleKernel",
    "ConstScaleKernel",
    "Scalar",
    "Const",
    "WhiteNoiseKernel",
    "RBFKernel",
    "ARDRBFKernel",
    "Matern12Kernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "DotProductKernel",
    "PolynomialKernel",
    "supports_matfree",
]
