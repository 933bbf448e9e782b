#!/usr/bin/env python3
"""The SLQ quadrature kernel against its first design inside one CG-lane
evaluation, on the card.

    python3 spark_gp_tpu_torch/dev/slq_ab.py [--lanes matfree,iterative] [--turns 2]

Builds the kernels, groups the protein-matfree configuration (E = 9,
s = 4065) and, on each solver lane, runs ``chip_smoke.replay_profile``
(the device optimizer's step and the objective evaluation alone, each
captured into a CUDA graph and replayed) with the wrapper bound to
``csrc/slq_quadrature.cu`` and to ``csrc/dev/slq_quadrature_first.cu`` in
turns: kernel, first design, first design, kernel (``--turns`` pairs).
Prints one JSON line a turn and one with each lane's means.  Needs one
CUDA card; run from the repo root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lanes", default="matfree,iterative")
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("slq_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cuda_lib.build_all(["streamed_matvec", "slq_quadrature", cs.SLQ_FIRST_DESIGN])
    first = sq.bind(cuda_lib.load(cs.SLQ_FIRST_DESIGN))
    designs = {"kernel": sq._library, "first_design": lambda: first}
    data = cs.main_path_data()
    mf_data = group_for_experts(data["xp"][data["tr"]], data["yp_tr"], 4096,
                                dtype=torch.float32, device="cuda")
    kernel = cs.matfree_gp(None, max_iter=3)._get_kernel()
    order = ["kernel", "first_design", "first_design", "kernel"] * args.turns
    for lane in args.lanes.split(","):
        got = {name: {"eval_ms_per_replay": [], "step_ms_per_replay": []} for name in designs}
        with it_ops.solver_lane_scope(lane):
            for name in order:
                sq._library = designs[name]
                try:
                    prof = cs.replay_profile(torch, kernel, mf_data)
                finally:
                    sq._library = designs["kernel"]
                for key in got[name]:
                    got[name][key].append(prof[key])
                print(json.dumps({"lane": lane, "design": name, **prof, "card": smi}), flush=True)
        means = {name: {key: float(np.mean(v)) for key, v in keys.items()}
                 for name, keys in got.items()}
        print(json.dumps({"lane": lane, "means": means,
                          "eval_saved_ms": means["first_design"]["eval_ms_per_replay"]
                          - means["kernel"]["eval_ms_per_replay"],
                          "step_saved_ms": means["first_design"]["step_ms_per_replay"]
                          - means["kernel"]["step_ms_per_replay"], "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
