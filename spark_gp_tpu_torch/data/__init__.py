"""Dataset loaders for the examples and the chip smoke run."""

from spark_gp_tpu_torch.data.datasets import (
    clustered_noise_floor,
    load_airfoil,
    load_iris,
    load_mnist_binary,
    load_protein,
    load_year_msd,
    make_clustered,
    make_heteroscedastic,
    make_synthetics,
)

__all__ = [
    "make_synthetics", "load_airfoil", "load_protein", "load_year_msd", "load_iris",
    "load_mnist_binary", "make_clustered", "make_heteroscedastic", "clustered_noise_floor",
]
