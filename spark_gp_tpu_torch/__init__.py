"""spark_gp_tpu_torch -- the PyTorch / CUDA port of ``spark_gp_tpu``.

Gaussian Process regression and classification (binary, and multiclass
by the softmax link) at scale with the reference library's design: a
Bayesian Committee Machine (product-of-experts) hyperparameter fit that
sums each expert's exact NLL (regression) or Laplace evidence
(classification) over its small gram,
and a Projected Process model on an m-point active set for prediction.
Regression also trains on the leave-one-out pseudo-likelihood or the
Titsias ELBO (``setObjective``), from several starting points
(``setNumRestarts``), with random, k-means or greedy (Seeger) inducing
points, and its model gives the joint posterior covariance, posterior
draws and online updates.  The binary classifier also runs Expectation
Propagation (probit), and count data fit by the Laplace approximation
with Poisson or Negative Binomial likelihoods.  Regression also predicts
by a product of experts (``poe_predictor``: PoE, gPoE, BCM, rBCM or the
healed product), and every fit screens out experts with non-finite rows
and recovers a failed attempt by per-expert jitter escalation and
quarantine (``setExpertQuarantine``, ``setFitRetries``).  Every fit
runs inside an observability shell (spans, a run journal, incident
bundles, an OpenMetrics page, profiler traces: ``obs/``) and a
degradation ladder that re-runs a fit failing for memory on the
iterative, the matrix-free and then the float64 lane (``resilience/``).
Kernels, theta layout, setter names and numerics match the JAX package,
which stays the reference the port is tested against.

Entry points run on ``cuda`` (float32) unless the caller asks for ``cpu``
(float64).  On the card the batched SPD inverse of every exact-lane
objective evaluation, and of every Newton iteration of the classifier,
is the hand-written CUDA kernel ``csrc/spd_inv_logdet.cu`` (for the
multiclass classifier, over every expert's and class's ``B_c`` at
once; for the LOO objective, the gram stack whatever the lane; for EP,
every site sweep's ``B``; for count regression, every Newton
iteration's ``B``); on the
matrix-free solver lane (``setSolverLane("matfree")``) every gram-matrix
product of the regression objective is the hand-written kernel
``csrc/streamed_matvec.cu``, and the ``[E, s, s]`` gram stack is never
built.  At the ``mixed`` and ``fast`` precision lanes
(``setPrecisionLane``) every float32 gram and cross kernel runs on the
TF32 tensor cores through ``csrc/lane_gram.cu`` (3xTF32, or one pass),
with a fit-time guard against the strict lane; from 2048 active points
on, the PPA magic solve runs in float64 on the fit's device.
"""

from spark_gp_tpu_torch.kernels import (
    ARDMatern32Kernel,
    ARDMatern52Kernel,
    ARDRationalQuadraticKernel,
    ARDRBFKernel,
    Const,
    DotProductKernel,
    EyeKernel,
    Kernel,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    PeriodicKernel,
    PolynomialKernel,
    ProductKernel,
    RationalQuadraticKernel,
    RBFKernel,
    Scalar,
    SpectralMixtureKernel,
    SumKernel,
    ThetaOverrideKernel,
    WhiteNoiseKernel,
)
from spark_gp_tpu_torch.models.active_set import (
    ActiveSetProvider,
    GreedilyOptimizingActiveSetProvider,
    KMeansActiveSetProvider,
    RandomActiveSetProvider,
)
from spark_gp_tpu_torch.models.gp_poisson import (
    GaussianProcessNegativeBinomialRegression,
    GaussianProcessPoissonModel,
    GaussianProcessPoissonRegression,
)
from spark_gp_tpu_torch.models.gpc import (
    GaussianProcessClassificationModel,
    GaussianProcessClassifier,
)
from spark_gp_tpu_torch.models.gpc_ep import (
    GaussianProcessEPClassificationModel,
    GaussianProcessEPClassifier,
)
from spark_gp_tpu_torch.models.gpc_mc import (
    GaussianProcessMulticlassClassifier,
    GaussianProcessMulticlassModel,
)
from spark_gp_tpu_torch.models.gpr import (
    GaussianProcessRegression,
    GaussianProcessRegressionModel,
)
from spark_gp_tpu_torch.ops.linalg import NotPositiveDefiniteException
from spark_gp_tpu_torch.resilience.quarantine import (
    ExpertQuarantineError,
    NonFiniteFitError,
)

__all__ = [
    "Kernel",
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
    "EyeKernel",
    "WhiteNoiseKernel",
    "SumKernel",
    "ProductKernel",
    "ThetaOverrideKernel",
    "Scalar",
    "Const",
    "GaussianProcessRegression",
    "GaussianProcessRegressionModel",
    "GaussianProcessClassifier",
    "GaussianProcessClassificationModel",
    "GaussianProcessMulticlassClassifier",
    "GaussianProcessMulticlassModel",
    "GaussianProcessEPClassifier",
    "GaussianProcessEPClassificationModel",
    "GaussianProcessPoissonRegression",
    "GaussianProcessNegativeBinomialRegression",
    "GaussianProcessPoissonModel",
    "ActiveSetProvider",
    "RandomActiveSetProvider",
    "KMeansActiveSetProvider",
    "GreedilyOptimizingActiveSetProvider",
    "NotPositiveDefiniteException",
    "ExpertQuarantineError",
    "NonFiniteFitError",
]
