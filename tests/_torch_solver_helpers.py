"""Shared pieces of the PyTorch port's solver-lane tests.

Both packages keep the solver lane and its knobs process-wide, so every
test starts and ends on the default lane with no inherited knob.  The
port draws its probes with a ``torch.Generator``; the tests hand it the
JAX package's own draws instead, so the two engines see the same probes
and compare deterministically.

Two knobs are pinned for every comparison, each for a stated reason:

* ``GP_SOLVER_PRECOND_RANK=16`` (below every expert size used): at
  rank = s the pivoted Cholesky consumes the whole matrix, ``delta`` drops
  to its floor and the Woodbury division by it amplifies rounding by
  ~1e13 -- a caveat of the reference (ROADMAP.md queue 3), and real fits
  run rank 64 << s;
* ``GP_SOLVER_CG_TOL=1e-12``: CG stopped at 1e-5 carries the rounding of
  each package's summation order, amplified step by step (about 1e-9
  relative after 20 steps on these stacks), into the iterates; run to
  convergence, both iterates are the solution to ~cond * eps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_gp_tpu.ops import iterative as j_it
from spark_gp_tpu_torch.ops import iterative as t_it


def jax_probes(cfg, batch, rank, s, dtype, device):
    """The JAX package's probe draws, in the port's ``draw_probes`` form."""
    k1, k2 = j_it._probe_keys(cfg.seed)
    g1 = jax.random.normal(k1, tuple(batch) + (rank, cfg.probes), dtype=jnp.float64)
    g2 = jax.random.normal(k2, tuple(batch) + (s, cfg.probes), dtype=jnp.float64)
    return (
        torch.as_tensor(np.array(g1), dtype=dtype, device=device),
        torch.as_tensor(np.array(g2), dtype=dtype, device=device),
    )


def jax_rademacher(cfg, shape, dtype, device):
    """The JAX package's Rademacher draw (``factored_logdet``), in the
    port's ``draw_rademacher`` form."""
    k1, _ = j_it._probe_keys(cfg.seed)
    z = jax.random.rademacher(k1, tuple(shape), dtype=jnp.float64)
    return torch.as_tensor(np.array(z), dtype=dtype, device=device)


@pytest.fixture
def solver_env(monkeypatch):
    """Default lanes in both packages, no inherited knobs, the two pinned
    knobs above, and the JAX probes injected into the port."""
    for var in [v for v in os.environ if v.startswith(("GP_SOLVER_", "GP_MATVEC_", "GP_MEMPLAN"))]:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GP_SOLVER_PRECOND_RANK", "16")
    monkeypatch.setenv("GP_SOLVER_CG_TOL", "1e-12")
    monkeypatch.setattr(t_it, "draw_probes", jax_probes)
    monkeypatch.setattr(t_it, "draw_rademacher", jax_rademacher)
    j_it.set_solver_lane(None)
    t_it.set_solver_lane(None)
    yield
    j_it.set_solver_lane(None)
    t_it.set_solver_lane(None)
