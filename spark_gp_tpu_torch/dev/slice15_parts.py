#!/usr/bin/env python3
"""chip_smoke.py's slice-15 phases (cost, expert-quality, quality), part
by part, on the card; a failing part does not stop the next.

    python3 spark_gp_tpu_torch/dev/slice15_parts.py [--parts cli,cost,eq,quality]

Builds the kernels, loads the data chip_smoke.py's main() would, fits and
saves the airfoil config on all 1503 rows, then runs each part: ``cli``
(``chip_smoke._serve_cli``: the serve CLI with its observe, which the
quality part reads), ``cost`` (``cost_phase``), ``eq``
(``expert_quality_phase``) and ``quality`` (``quality_phase``), printing
their phase lines and a traceback for a part that fails.  Needs one CUDA
card; run from the repo root.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PARTS = ("cli", "cost", "eq", "quality")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default=",".join(PARTS))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("slice15_parts: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.ops import lane_gram as lg
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.ops import spd_linalg as spd
    from spark_gp_tpu_torch.ops import streamed_matvec as sm
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cuda_lib.build_all(["spd_inv_logdet", "streamed_matvec", "slq_quadrature", "lane_gram"])
    data_main, cdata = cs.main_path_data(), cs.classifier_data()
    xp, tr = data_main["xp"], data_main["tr"]
    mf_data = group_for_experts(xp[tr], data_main["yp_tr"], 4096, dtype=torch.float32,
                                device="cuda")
    counts = cs.LaunchCounts(spd, sm, sq, lg)
    work = tempfile.mkdtemp(prefix="gp_slice15_parts_")
    path = os.path.join(work, "airfoil.npz")
    cs.airfoil_gp(100).fit(data_main["x"], data_main["y"]).save(path)

    def cli():
        out = cs._serve_cli(path)
        cs.emit({"phase": "serve-cli", **out, "card": smi})
        cs.CLI_OBSERVED.update(out["observed"] or {})

    parts = {
        "cli": cli,
        "cost": lambda: cs.cost_phase(torch, spd, sm, sq, data_main, cdata, path, counts, smi),
        "eq": lambda: cs.expert_quality_phase(torch, spd, sm, sq, data_main, mf_data, counts,
                                              smi),
        "quality": lambda: cs.quality_phase(torch, data_main, path, counts, smi),
    }
    failed = 0
    try:
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"launches": counts.launches, "card": smi}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
