#!/usr/bin/env python3
"""chip_smoke.py's device-optimizer phases on the CG lanes and for EP,
part by part, on the card; a failing part does not stop the next.

    python3 spark_gp_tpu_torch/dev/slice12_parts.py [--parts slq,regression,latent,ep,ladder]
        [--newton-k-cg N]

Builds the kernels, loads the data chip_smoke.py's main() would, fits the
host protein-matfree model for its RMSE (the bars' reference), then runs
each part of ``chip_smoke.slice12_phases`` (``slq_quadrature_phase``,
``cg_regression_phases``, ``cg_latent_phases``, ``ep_device_phases``,
``ladder_oom_device_phase``), printing their phase lines and a
traceback for a part that fails.  ``--newton-k-cg`` sets every family's
Newton iterations a step on the CG lanes (``laplace_device.NEWTON_K_CG``),
the measurement behind its values.  The host-against-device rows have no
host side but protein-matfree's.  Needs one CUDA card; run from the repo
root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PARTS = ("slq", "regression", "latent", "ep", "ladder")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default=",".join(PARTS))
    parser.add_argument("--newton-k-cg", type=int, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("slice12_parts: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.models import ep
    from spark_gp_tpu_torch.models import laplace as lap
    from spark_gp_tpu_torch.models import laplace_device
    from spark_gp_tpu_torch.models import laplace_generic as lap_gen
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.ops import spd_linalg as spd
    from spark_gp_tpu_torch.ops import streamed_matvec as sm
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.utils.validation import rmse

    if args.newton_k_cg is not None:
        for family in laplace_device.NEWTON_K:
            if family != "ep":
                laplace_device.NEWTON_K_CG[family] = args.newton_k_cg
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cuda_lib.build_all(["spd_inv_logdet", "streamed_matvec", "slq_quadrature",
                        cs.SLQ_FIRST_DESIGN])
    data_main, cdata, d6 = cs.main_path_data(), cs.classifier_data(), cs.slice6_data()
    xp, yp, tr, te = (data_main[k] for k in ("xp", "yp", "tr", "te"))
    mf_data = group_for_experts(xp[tr], data_main["yp_tr"], 4096, dtype=torch.float32,
                                device="cuda")
    b = cs.gpc_b_stacks(torch, lap, cdata)
    stacks = cs.slice6_stacks(torch, ep, lap_gen, d6, cdata)
    b_stacks = {"gpc_mnist_b": b["gpc_mnist"], "poisson_b": stacks["poisson_b"],
                "iris_b": b["iris_fold"]}
    start = time.perf_counter()
    try:
        model = cs.matfree_gp("matfree").fit(xp[tr], data_main["yp_tr"])
    finally:
        it_ops.set_solver_lane(None)
    pred = model.predict(xp[te]) * data_main["y_std"] + data_main["y_mean"]
    mf_rmse = rmse(yp[te], pred)
    host = {"protein_matfree": {"rmse": mf_rmse, "fit_seconds": time.perf_counter() - start,
                                "optimize_seconds": model.metrics["optimize_seconds"],
                                "nfev": model.metrics["lbfgs_nfev"]}}
    counts, rows = cs.LaunchCounts(spd, sm, sq), []
    name = torch.cuda.get_device_name(0)
    parts = {
        "slq": lambda: cs.slq_quadrature_phase(
            torch, sq, cs.slq_tridiagonals(torch, it_ops, mf_data,
                                           cs.matfree_gp(None)._get_kernel(), b_stacks),
            cs.peaks_for(name), cs.card_peaks(name).f64, smi),
        "regression": lambda: cs.cg_regression_phases(torch, it_ops, counts, data_main, mf_data,
                                                      cdata, mf_rmse, host, rows, smi),
        "latent": lambda: cs.cg_latent_phases(torch, it_ops, counts, cdata, d6, host, rows, smi),
        "ep": lambda: cs.ep_device_phases(torch, counts, cdata, host, rows, smi),
        "ladder": lambda: cs.ladder_oom_device_phase(torch, it_ops, counts, data_main, mf_rmse,
                                                     smi),
    }
    failed = 0
    for label in args.parts.split(","):
        start = time.perf_counter()
        try:
            parts[label]()
            print(json.dumps({"part": label, "ok": True,
                              "seconds": time.perf_counter() - start}), flush=True)
        except Exception:  # a failing part is reported and the next one runs
            failed += 1
            print(json.dumps({"part": label, "ok": False,
                              "seconds": time.perf_counter() - start}), flush=True)
            print(traceback.format_exc(), flush=True)
            it_ops.set_solver_lane(None)
            torch.cuda.set_per_process_memory_fraction(1.0)
    print(json.dumps({"rows": rows, "launches": counts.launches, "card": smi}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
