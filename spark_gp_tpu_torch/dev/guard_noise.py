#!/usr/bin/env python3
"""How far the precision guard's objective probe moves by float32 rounding
alone, on the CPU.

    python3 spark_gp_tpu_torch/dev/guard_noise.py [--inverse] [--folds 3]

Fits the airfoil config (expert 100) on the first ``--folds`` CV folds in
float64 on the CPU, then evaluates the guard's probe
(``likelihood.guard_probe_value_and_grad``) on each fold's first expert
at the fitted theta with the stack in float32 at the strict, mixed and
fast lanes (the lane kernel's plain version), in float64, and with a
4-pass split (``lo1 lo2`` kept) in place of the mixed lane's 3 passes.
Prints each gradient's distance from the strict float32 one and from the
float64 one, over the guard's scale.  ``--inverse`` sends the probe's
objective through the explicit-inverse route K1 takes on the card
(``spd_inv_logdet_plain``) in place of its float64 Cholesky; without
it the probe runs as the port ships it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--inverse", action="store_true")
    parser.add_argument("--folds", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from spark_gp_tpu_torch.models import likelihood as lk
    from spark_gp_tpu_torch.ops import lane_gram as lg
    from spark_gp_tpu_torch.ops import spd_linalg as spd
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    def probe_float32_inverse(kernel, theta, x, y, mask, *, lane):
        """The probe's objective as a float32 fit evaluates it on the card:
        the gram at the lane, then K^-1 explicitly."""
        with lk.precision_lane_scope(lane), torch.enable_grad():
            t = theta.detach().clone().requires_grad_(True)
            kmat = lk.masked_gram_stack(kernel, t, x, mask)
            value = lk.nll_from_inverse(kmat, y * mask, inv_logdet=spd.spd_inv_logdet_plain)
            (grad,) = torch.autograd.grad(value, t)
        return value.detach(), grad

    probe = probe_float32_inverse if args.inverse else lk.guard_probe_value_and_grad

    def four_pass(x1, x2, mode):
        hi1, lo1 = lg.split_tf32(x1)
        hi2, lo2 = lg.split_tf32(x2)
        return hi1 @ hi2.mT + (hi1 @ lo2.mT + lo1 @ hi2.mT + lo1 @ lo2.mT)

    d = cs.main_path_data()
    x, y, folds = d["x"], d["y"], d["folds"]
    for fold in range(args.folds):
        train = folds[fold][0]
        model = cs.airfoil_gp(100).setDevice("cpu").fit(x[train], y[train])
        theta, kernel = model.raw_predictor.theta, model.raw_predictor.kernel
        grads = {}
        for label, dtype in (("strict", torch.float32), ("mixed", torch.float32),
                             ("fast", torch.float32), ("float64", torch.float64),
                             ("mixed_4pass", torch.float32)):
            data = group_for_experts(x[train], y[train], 100, dtype=dtype, device="cpu")
            lane = {"float64": "strict", "mixed_4pass": "mixed"}.get(label, label)
            inner = lg.lane_inner_plain
            if label == "mixed_4pass":
                lg.lane_inner_plain = four_pass
            try:
                _, grad = probe(kernel, torch.as_tensor(theta, dtype=dtype), data.x[:1],
                                data.y[:1], data.mask[:1], lane=lane)
            finally:
                lg.lane_inner_plain = inner
            grads[label] = grad.double().numpy()
        scale = max(np.abs(grads["strict"]).max(), 97.0)
        print(json.dumps({"fold": fold, "inverse": args.inverse, **{
            f"{ref}_vs_{k}": float(np.abs(g - grads[ref]).max() / scale)
            for ref in ("strict", "float64") for k, g in grads.items() if k != ref}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
