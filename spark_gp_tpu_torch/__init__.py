"""spark_gp_tpu_torch -- the PyTorch / CUDA port of ``spark_gp_tpu``.

Gaussian Process regression at scale with the reference library's design:
a Bayesian Committee Machine (product-of-experts) hyperparameter fit that
sums the exact NLL of each expert's small gram, and a Projected Process
model on an m-point active set for prediction.  Kernels, theta layout,
setter names and numerics match the JAX package, which stays the
reference the port is tested against.

Entry points run on ``cuda`` (float32) unless the caller asks for ``cpu``
(float64).  On the card the batched SPD inverse of every exact-lane
objective evaluation is the hand-written CUDA kernel
``csrc/spd_inv_logdet.cu``; on the matrix-free solver lane
(``setSolverLane("matfree")``) every gram-matrix product is the
hand-written kernel ``csrc/streamed_matvec.cu``, and the ``[E, s, s]``
gram stack is never built.
"""

from spark_gp_tpu_torch.kernels import (
    ARDRBFKernel,
    Const,
    DotProductKernel,
    EyeKernel,
    Kernel,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    PolynomialKernel,
    RationalQuadraticKernel,
    RBFKernel,
    Scalar,
    SumKernel,
    WhiteNoiseKernel,
)
from spark_gp_tpu_torch.models.active_set import (
    ActiveSetProvider,
    RandomActiveSetProvider,
)
from spark_gp_tpu_torch.models.gpr import (
    GaussianProcessRegression,
    GaussianProcessRegressionModel,
)
from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException

__all__ = [
    "Kernel",
    "RBFKernel",
    "ARDRBFKernel",
    "Matern12Kernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "DotProductKernel",
    "PolynomialKernel",
    "EyeKernel",
    "WhiteNoiseKernel",
    "SumKernel",
    "Scalar",
    "Const",
    "GaussianProcessRegression",
    "GaussianProcessRegressionModel",
    "ActiveSetProvider",
    "RandomActiveSetProvider",
    "NotPositiveDefiniteException",
]
