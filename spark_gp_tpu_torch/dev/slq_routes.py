#!/usr/bin/env python3
"""Why the SLQ quadrature has a kernel, and how close the float32 engine
comes to the float64 one, on the card.

    python3 spark_gp_tpu_torch/dev/slq_routes.py

1. ``torch.linalg.eigh`` under CUDA-graph capture, on float32 stacks of
   ``[9, 8, 63, 63]`` and ``[9, 8, 64, 64]`` (protein-matfree's Lanczos
   matrices: 9 experts x 8 probes), each capture in a subprocess of its
   own (a refused capture leaves cuSOLVER unusable in its process): one
   JSON line per shape with the refusal's text.
2. The matrix-free objective of chip_smoke.py's protein-matfree config
   (E = 9, s = 4065) at its initial theta and at 0.8x and 1.25x it, with
   the card's probes, three ways: the engine as it ships (the quadrature
   kernel ``csrc/slq_quadrature.cu``, the pivoted Cholesky in float64),
   its quadrature by the float32 ``eigh`` route instead, and its pivoted
   Cholesky in float32 (:func:`float32_pivots`); each value against the
   same objective in float64 on the CPU (matfree-parity's reference).
   One JSON line per theta.

Needs one CUDA card; run from the repo root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r'''
import json, sys, torch
shape = tuple(int(v) for v in sys.argv[1].split(","))
g = torch.Generator(device="cuda")
g.manual_seed(0)
a = torch.randn(*shape, device="cuda", generator=g)
t = a @ a.mT + shape[-1] * torch.eye(shape[-1], device="cuda")
torch.linalg.eigh(t)
torch.cuda.synchronize()
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        torch.linalg.eigh(t)
    print(json.dumps({"shape": shape, "eigh_capture": "captured"}))
except Exception as exc:
    print(json.dumps({"shape": shape, "eigh_capture": "refused",
                      "error": f"{type(exc).__name__}: {exc}"}))
'''


def float32_pivots(diag0, col_fn, rank: int):
    """``ops.iterative.pivoted_cholesky_cols`` with its arithmetic in the
    stack's own dtype (float32 on the card), the counterfactual of part 2."""
    import torch

    s = diag0.shape[-1]
    k = max(1, min(int(rank), s))
    batch = diag0.shape[:-1]
    trace = torch.sum(diag0, dim=-1)
    scale = torch.where(trace > 0, trace / s, torch.ones_like(trace))
    floor = 100.0 * torch.finfo(diag0.dtype).eps * scale
    lmat = diag0.new_zeros(batch + (s, k))
    d = diag0
    iota = torch.arange(s, device=diag0.device)
    for j in range(k):
        piv = torch.argmax(d, dim=-1)
        dmax = torch.gather(d, -1, piv[..., None])[..., 0]
        ok = dmax > floor
        lrow = torch.gather(lmat, -2, piv[..., None, None].expand(batch + (1, k)))[..., 0, :]
        proj = torch.einsum("...sk,...k->...s", lmat, lrow)
        denom = torch.sqrt(torch.where(ok, dmax, 1.0))
        newcol = torch.where(ok[..., None], (col_fn(piv) - proj) / denom[..., None], 0.0)
        lmat[..., :, j] = newcol
        d = torch.clamp_min(d - newcol * newcol, 0.0)
        d = torch.where(iota == piv[..., None], -torch.inf, d)
    resid = torch.where(d > 0, d, 0.0)
    return lmat, torch.maximum(torch.sum(resid, dim=-1) / max(s - k, 1), floor)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("slq_routes: no CUDA device available", file=sys.stderr)
        return 2
    for shape in ("9,8,63,63", "9,8,64,64"):
        out = subprocess.run([sys.executable, "-c", PROBE, shape], capture_output=True,
                             text=True, timeout=300)
        print(out.stdout.strip() or json.dumps({"shape": shape, "probe_failed": out.stderr[-2000:]}),
              flush=True)

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch import Const, EyeKernel
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    cuda_lib.build_all(["streamed_matvec", "slq_quadrature"])
    d = cs.main_path_data()
    xp, tr, y_tr = d["xp"], d["tr"], d["yp_tr"]
    card = group_for_experts(xp[tr], y_tr, 4096, dtype=torch.float32, device="cuda")
    cpu = group_for_experts(xp[tr], y_tr, 4096, dtype=torch.float64, device="cpu")
    kernel = cs.matfree_kernel() + Const(1e-3) * EyeKernel()
    cfg = it_ops.solver_config(4065)
    g1, g2 = it_ops.draw_probes(cfg, (9,), cfg.rank, 4065, torch.float32, "cuda")
    it_ops.draw_probes = lambda cfg, batch, rank, s, dtype, device: (
        g1.to(device=device, dtype=dtype), g2.to(device=device, dtype=dtype))
    shipped = (sq.slq_quadrature, it_ops.pivoted_cholesky_cols)
    routes = {
        "engine": shipped,
        "eigh_f32": (sq.slq_quadrature_plain, shipped[1]),
        "float32_pivots": (shipped[0], float32_pivots),
    }
    it_ops.set_solver_lane("matfree")
    try:
        for scale in (1.0, 0.8, 1.25):
            theta = kernel.init_theta() * scale
            ref = make_value_and_grad(kernel, cpu)(theta)[0]
            row = {"theta_scale": scale, "cpu_f64": ref}
            for name, (quadrature, pivots) in routes.items():
                sq.slq_quadrature, it_ops.pivoted_cholesky_cols = quadrature, pivots
                value = make_value_and_grad(kernel, card)(theta)[0]
                sq.slq_quadrature, it_ops.pivoted_cholesky_cols = shipped
                row[name] = {"value": value, "rel_err_vs_cpu_f64": abs(value - ref) / abs(ref)}
            print(json.dumps(row), flush=True)
    finally:
        sq.slq_quadrature, it_ops.pivoted_cholesky_cols = shipped
        it_ops.set_solver_lane(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
