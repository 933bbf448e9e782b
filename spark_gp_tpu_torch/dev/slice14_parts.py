#!/usr/bin/env python3
"""chip_smoke.py's slice 14 phases on their own, on the card.

    python3 spark_gp_tpu_torch/dev/slice14_parts.py [--parts lanegram,largem,lanes]

Builds K1 and the lane kernel, loads the data and runs the chosen parts of
``chip_smoke.slice14_phases``: ``lanegram`` (lane-gram-check and
lane-gram-time), ``largem`` (large-m, large-m-crossover, large-m-oom),
``lanes`` (lanes-airfoil, lanes-synthetics, lanes-device, lanes-breach,
lanes-breach-log, lanes-k1), each printing chip_smoke's JSON lines.  Needs
one CUDA card; run from the repo root.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default="lanegram,largem,lanes")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("slice14_parts: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.ops import lane_gram as lg
    from spark_gp_tpu_torch.ops import spd_linalg as spd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    start = time.perf_counter()
    cuda_lib.build_all(["spd_inv_logdet", "lane_gram"])
    cs.emit({"phase": "build", "seconds": time.perf_counter() - start, "card": smi})
    parts = args.parts.split(",")
    data_main, rdata = cs.main_path_data(), cs.regression_data()
    if "lanegram" in parts:
        inputs = cs.lane_gram_inputs(torch, data_main, rdata)
        cs.emit({"phase": "lane-gram-check", "max_err_over_scale":
                 cs.check_lane_gram(torch, lg, inputs), "card": smi})
        name = torch.cuda.get_device_name(0)
        cs.emit({"phase": "lane-gram-time", "rows": cs.time_lane_gram(
            torch, lg, inputs, cs.peaks_for(name), cs.card_peaks(name).tf32), "card": smi})
    if "largem" in parts:
        cs.large_m_phases(torch, spd, smi)
    if "lanes" in parts:
        cs.lanes_phases(torch, lg, spd, data_main, rdata, smi)
    cs.emit({"phase": "done", "seconds": time.perf_counter() - start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
