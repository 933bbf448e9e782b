"""Why the SLQ quadrature kernel forms no eigenvalue weights: two routes to
``e1^T log(T) e1`` in numpy on the CPU, against float64 ``eigh``.

    python3 spark_gp_tpu_torch/csrc/dev/slq_weight_routes.py

On float64 Lanczos tridiagonals of PCG runs past their convergence
(``emulate.lanczos_stack`` with ``tol=0``: 20 and 64 steps on 20 rows,
whose Ritz values repeat), it prints for each route the largest error
against the ``eigh`` route (``ops/slq_quadrature.slq_quadrature_plain``)
and the smallest gap between T's eigenvalues:

- ``weights``: each eigenvalue by bisection on the Sturm count, its weight
  ``1 / s_1'(lambda)`` from the bottom-up pivots of ``lambda I - T`` (the
  route ``csrc/slq_quadrature.cu`` does not take);
- ``integral``: the kernel's route, ``int (1/(1+s) - e1^T (T + sI)^-1 e1)
  ds`` by the trapezoid rule in ``u = log s`` at the kernel's step and
  reach (``kStep``, ``kTailLo``, ``kPadHi``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parents[2]))

import emulate  # noqa: E402
from spark_gp_tpu_torch.ops import slq_quadrature as sq  # noqa: E402

EPS = np.finfo(np.float64).eps


def by_weights(d: np.ndarray, e: np.ndarray) -> float:
    """Bisection for every eigenvalue, weight 1 / s_1'(lambda)."""
    t, e2 = len(d), e * e
    rad = np.abs(np.r_[0.0, e]) + np.abs(np.r_[e, 0.0])
    lo, hi = np.full(t, (d - rad).min()), np.full(t, (d + rad).max())
    k = np.arange(t)
    for _ in range(100):  # count of eigenvalues below mid, all t at once
        mid = 0.5 * (lo + hi)
        q, below = d[0] - mid, (d[0] - mid < 0).astype(int)
        for j in range(1, t):
            q = d[j] - mid - e2[j - 1] / np.where(q == 0.0, EPS * EPS, q)
            below += q < 0
        hi, lo = np.where(below > k, mid, hi), np.where(below > k, lo, mid)
    lam = 0.5 * (lo + hi)
    s, ds = lam - d[-1], np.ones(t)
    for j in range(t - 2, -1, -1):
        s = np.where(s == 0.0, EPS * EPS, s)
        r = e2[j] / s
        ds, s = 1.0 + r * ds / s, lam - d[j] - r
    return float(np.sum(np.log(np.maximum(lam, 1e-12)) / ds))


def by_integral(d: np.ndarray, e: np.ndarray, step=0.5, tail_lo=1e-17, pad_hi=40.0) -> float:
    """The kernel's trapezoid rule (for an SPD T over the clamp)."""
    rad = np.abs(np.r_[0.0, e]) + np.abs(np.r_[e, 0.0])
    u_lo, u_hi = np.log(tail_lo * 1e-12), np.log(max(1.0, (d + rad).max())) + pad_hi
    s = np.exp(u_lo + step * np.arange(int(np.ceil((u_hi - u_lo) / step)) + 1))
    q = d[-1] + s
    for j in range(len(d) - 2, 0, -1):
        q = d[j] + s - e[j] ** 2 / q
    r = d[0] - 1.0 - (e[0] ** 2 / q if len(d) > 1 else 0.0)
    return float(step * np.sum(s * r / ((1.0 + s) * (r + 1.0 + s))))


def main() -> int:
    rng = np.random.default_rng(0)
    for steps in (20, 64):
        diag, off = (a.reshape(-1, a.shape[-1])
                     for a in emulate.lanczos_stack(1, 20, steps, rng, np.float64, tol=0.0))
        ref = sq.slq_quadrature_plain(torch.as_tensor(diag), torch.as_tensor(off)).numpy()
        gaps = [np.diff(np.linalg.eigvalsh(np.diag(d) + np.diag(o, 1) + np.diag(o, -1))).min()
                for d, o in zip(diag, off)]
        for name, route in (("weights", by_weights), ("integral", by_integral)):
            err = max(abs(route(d, o) - r) / max(1.0, abs(r)) for d, o, r in zip(diag, off, ref))
            print(f"{steps} steps on 20 rows, {name}: largest error {err:.2e}, "
                  f"smallest eigenvalue gap {min(gaps):.1e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
