"""One intra-op thread for PyTorch in the port's test processes.

The suite runs in several worker processes on one machine, and a
PyTorch OpenMP pool per process at the full core count oversubscribes
the cores: on an 8-core machine the port's tests took 423 s under six
workers with the default pools and 150 s with one thread each, and the
CUDA-emulation tests, whose blocks are real threads meeting at barriers,
slow down most.  Every port test module imports this one."""

import torch

torch.set_num_threads(1)
