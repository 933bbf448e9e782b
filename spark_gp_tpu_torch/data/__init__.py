"""Dataset loaders for the examples and the chip smoke run."""

from spark_gp_tpu_torch.data.datasets import (
    load_airfoil,
    load_iris,
    load_mnist_binary,
    load_protein,
    load_year_msd,
    make_synthetics,
)

__all__ = [
    "make_synthetics", "load_airfoil", "load_protein", "load_year_msd", "load_iris",
    "load_mnist_binary",
]
