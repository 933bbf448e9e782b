#!/usr/bin/env python3
"""The spectral mixture's product over inputs, multiplied out (the
kernel's form) against ``torch.prod`` (its earlier form), on the card.

    python3 spark_gp_tpu_torch/dev/sm_product_ab.py [--repeats 2]

``chip_smoke.py``'s timeseries-sm config (``timeseries_gp("sm")``: eight
host restarts, E = 2, s = 120, float32) is fitted with each form in
turns, ``--repeats`` times each; one JSON line per fit with the
evaluations of every restart, the extrapolation RMSE, each restart's
final NLL and the winner, then the card's name and power limit.  The two
forms agree in exact arithmetic; the lines show whether float32 moves
the fit's trajectory and whether a form repeats itself.  Needs one CUDA
card; run from the repo root.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def prod_form(self, theta, x_a, x_b):
    """The spectral mixture gram with ``torch.prod`` over the inputs."""
    import torch

    w, mu, v = self._split(theta)
    tau = x_a[..., :, None, :] - x_b[..., None, :, :]
    expo = torch.einsum("...abp,qp->...qab", tau * tau, (-2.0 * math.pi ** 2) * v)
    cosp = torch.prod(torch.cos((2.0 * math.pi) * tau[..., None, :, :, :]
                                * mu[:, None, None, :]), dim=-1)
    return torch.einsum("q,...qab->...ab", w, torch.exp(expo) * cosp)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.kernels import families
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.utils.validation import rmse

    cuda_lib.build_all(["spd_inv_logdet"])
    forms = {"multiplied_out": families.SpectralMixtureKernel._k, "torch_prod": prod_form}
    xs, ys, xe, ye = cs.timeseries_data()
    try:
        for _ in range(args.repeats):
            for label, form in forms.items():
                families.SpectralMixtureKernel._k = form
                model = cs.timeseries_gp("sm").fit(xs, ys)
                m = model.metrics
                print(json.dumps({
                    "form": label, "restarts_nfev": m["restarts_nfev"],
                    "extrapolation_rmse": rmse(ye, model.predict(xe)),
                    "restart_nlls": [m[f"restart_{r}_nll"] for r in range(m["num_restarts"])],
                    "best_restart": m["best_restart"]}), flush=True)
    finally:
        families.SpectralMixtureKernel._k = forms["multiplied_out"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
