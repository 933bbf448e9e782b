"""Covariance kernels and the composition DSL (see ``base.py``)."""

from spark_gp_tpu_torch.kernels.base import (
    Const,
    ConstScaleKernel,
    EyeKernel,
    Kernel,
    ProductKernel,
    Scalar,
    StationaryKernel,
    SumKernel,
    ThetaOverrideKernel,
    TrainableScaleKernel,
    WhiteNoiseKernel,
    supports_matfree,
)
from spark_gp_tpu_torch.kernels.families import (
    ARDRationalQuadraticKernel,
    DotProductKernel,
    PeriodicKernel,
    PolynomialKernel,
    RationalQuadraticKernel,
    SpectralMixtureKernel,
)
from spark_gp_tpu_torch.kernels.matern import (
    ARDMatern32Kernel,
    ARDMatern52Kernel,
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
    "ProductKernel",
    "ThetaOverrideKernel",
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
    "ARDMatern32Kernel",
    "ARDMatern52Kernel",
    "RationalQuadraticKernel",
    "ARDRationalQuadraticKernel",
    "PeriodicKernel",
    "SpectralMixtureKernel",
    "DotProductKernel",
    "PolynomialKernel",
    "supports_matfree",
]
