"""Hyperparameter optimizers: L-BFGS-B on the host (SciPy, ``lbfgsb.py``)
and on the device (``lbfgs_device.py``)."""
