#!/usr/bin/env python3
"""Two checkouts of the repo side by side on one card, in one process tree.

    python3 spark_gp_tpu_torch/dev/ab_compare.py \\
        --tree parent=DIR --tree change=DIR --order parent,change,change,parent \\
        --out chiprun_out/ab

Each leg, in the given order, runs one checkout's ``chip_smoke.py`` from
its root (the whole script, timed, its output in ``OUT/<i>_<label>.log``),
then this script's ``--leg`` harness against that checkout's package:

* the airfoil config's first fold (E = 14, s = 97, ARD, m = 1000): three
  fits after a warm-up, each with its ``group_seconds``,
  ``optimize_seconds`` and ``ppa_seconds``, and the 1503-row predict
  (mean, and mean with variance), the median of 20 synchronized calls,
  and the eager predict block (``_predict_block``, the body a serving
  graph holds) at 8 ... 256 rows of the fold model, the median of 50;
* the protein config (45,730 x 9 stand-in, 80/20 split, expert 100,
  m = 1000, maxiter 10): one fit's phase seconds, the 9,146-row predict
  (mean, and mean with variance; medians of 10), and the PPA statistics
  (``ppa.kmn_stats``) at the fitted theta and active set, the median of 5;
* where the checkout has the fit's tracing switch (``GP_TRACING``):
  single-fit pairs on the airfoil fold, tracing off and on in turns
  (ten pairs, the order alternating), each pair's ratio.

``--no-smoke`` runs the harness alone in each leg.  Prints one JSON line per leg and, last, the card's name and power limit
and a summary; every line also lands in ``OUT/ab.jsonl``.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def _sync_ms(torch, fn, reps: int) -> float:
    """Median wall milliseconds of ``fn()`` over ``reps`` synchronized calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


def run_leg(tree: str) -> dict:
    """The harness against the package of the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from spark_gp_tpu_torch import GaussianProcessRegression
    from spark_gp_tpu_torch.models import ppa
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    phases = ("group_seconds", "optimize_seconds", "ppa_seconds")
    d = cs.main_path_data()
    x, y = d["x"], d["y"]
    train = d["folds"][0][0]
    out = {"tree": tree, "has_tracing": os.path.isdir(os.path.join(tree, "spark_gp_tpu_torch", "obs"))}

    def airfoil_fit():
        start = time.perf_counter()
        model = cs.airfoil_gp(100).fit(x[train], y[train])
        torch.cuda.synchronize()
        return model, time.perf_counter() - start

    airfoil_fit()  # builds and warms the kernels
    fits = []
    for _ in range(3):
        model, seconds = airfoil_fit()
        fits.append({"fit_seconds": seconds, **{k: model.metrics[k] for k in phases}})
    raw = model.raw_predictor
    theta, active = (torch.as_tensor(a, device="cuda").to(torch.float32)
                     for a in (raw.theta, raw.active))
    mv, mm = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
              for a in (raw.magic_vector, raw.magic_matrix))
    block_ms = {}
    for rows in (8, 16, 32, 64, 128, 256):
        part = torch.as_tensor(x[:rows], device="cuda").to(torch.float32)
        with torch.no_grad():
            block_ms[str(rows)] = _sync_ms(
                torch, lambda: raw._predict_block(theta, active, mv, mm, part), 50)
    out["airfoil"] = {
        "fits": fits,
        **{f"median_{k}": float(np.median([f[k] for f in fits])) for k in ("fit_seconds",) + phases},
        "predict_1503_mean_ms": _sync_ms(torch, lambda: model.predict(x), 20),
        "predict_1503_mean_var_ms": _sync_ms(torch, lambda: model.predict_with_var(x), 20),
        "predict_block_eager_ms": block_ms,
    }

    xp, tr, te, yp_tr = d["xp"], d["tr"], d["te"], d["yp_tr"]
    gp = (GaussianProcessRegression().setKernel(cs.protein_kernel).setDatasetSizeForExpert(100)
          .setActiveSetSize(1000).setSigma2(1e-3).setMaxIter(10).setSeed(13))
    start = time.perf_counter()
    model = gp.fit(xp[tr], yp_tr)
    torch.cuda.synchronize()
    raw = model.raw_predictor
    data = group_for_experts(xp[tr], yp_tr, 100, dtype=torch.float64, device="cuda")
    theta, active = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
                     for a in (raw.theta, raw.active))
    out["protein"] = {
        "fit_seconds": time.perf_counter() - start,
        **{k: model.metrics[k] for k in phases},
        "predict_9146_mean_ms": _sync_ms(torch, lambda: model.predict(xp[te]), 10),
        "predict_9146_mean_var_ms": _sync_ms(torch, lambda: model.predict_with_var(xp[te]), 10),
        "kmn_stats_ms": _sync_ms(torch, lambda: ppa.kmn_stats(raw.kernel, theta, active, data), 5),
        "stats_chunk_elems": ppa._STATS_CHUNK_ELEMS,
    }

    if out["has_tracing"]:
        pairs = []
        for pair in range(10):
            seconds = {}
            for mode in (("off", "on") if pair % 2 == 0 else ("on", "off")):
                if mode == "off":
                    os.environ["GP_TRACING"] = "0"
                try:
                    seconds[mode] = airfoil_fit()[1]
                finally:
                    os.environ.pop("GP_TRACING", None)
            pairs.append({**seconds, "ratio": seconds["on"] / seconds["off"] - 1.0})
        ratios = [p["ratio"] for p in pairs]
        out["tracing_single_fit_pairs"] = {
            "pairs": pairs, "median_ratio": float(np.median(ratios)),
            "positive": sum(r > 0 for r in ratios),
            "off_seconds_min_max": [min(p["off"] for p in pairs), max(p["off"] for p in pairs)],
            "on_seconds_min_max": [min(p["on"] for p in pairs), max(p["on"] for p in pairs)],
        }
    return out


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--leg", help="run the harness against the checkout at this path")
    parser.add_argument("--tree", action="append", default=[], help="LABEL=DIR")
    parser.add_argument("--order", default="", help="labels, comma-separated")
    parser.add_argument("--out", default="chiprun_out/ab")
    parser.add_argument("--smoke-timeout", type=float, default=1200.0)
    parser.add_argument("--no-smoke", action="store_true",
                        help="skip each leg's chip_smoke.py run")
    args = parser.parse_args()
    if args.leg:
        print(json.dumps(run_leg(args.leg)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ab_compare: no CUDA device available", file=sys.stderr)
        return 2
    trees = dict(item.split("=", 1) for item in args.tree)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    record = open(os.path.join(out_dir, "ab.jsonl"), "a", encoding="utf-8")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        record.write(line + "\n")
        record.flush()

    ok = True
    summary = []
    for i, label in enumerate(args.order.split(",")):
        tree = os.path.abspath(trees[label])
        log = os.path.join(out_dir, f"{i}_{label}.log")
        start = time.perf_counter()
        with open(log, "w", encoding="utf-8") as fh:
            try:
                rc = 0 if args.no_smoke else subprocess.run(
                    [sys.executable, "chip_smoke.py"], cwd=tree, stdout=fh,
                    stderr=subprocess.STDOUT, timeout=args.smoke_timeout).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        smoke_s = time.perf_counter() - start
        phase_seconds = {}
        with open(log, encoding="utf-8") as fh:
            for line in fh:
                if line.startswith("{\"phase\""):
                    row = json.loads(line)
                    for key in ("seconds", "fit_seconds", "ppa_seconds"):
                        if isinstance(row.get(key), (int, float)):
                            phase_seconds.setdefault(row["phase"], {})[key] = row[key]
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", tree],
                              capture_output=True, text=True, timeout=1200)
        harness = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else {
            "rc": proc.returncode, "stderr_tail": proc.stderr[-2000:]}
        row = {"leg": i, "label": label, "smoke_rc": rc, "smoke_seconds": smoke_s,
               "smoke_phase_seconds": phase_seconds, "harness_seconds": time.perf_counter() - start,
               "harness": harness}
        emit(row)
        ok = ok and rc == 0 and proc.returncode == 0
        summary.append({"label": label, "smoke_rc": rc, "smoke_seconds": smoke_s,
                        "airfoil_ppa_s": harness.get("airfoil", {}).get("median_ppa_seconds"),
                        "protein_ppa_s": harness.get("protein", {}).get("ppa_seconds"),
                        "predict_1503_ms": harness.get("airfoil", {}).get("predict_1503_mean_ms"),
                        "predict_1503_var_ms": harness.get("airfoil", {}).get(
                            "predict_1503_mean_var_ms"),
                        "predict_9146_ms": harness.get("protein", {}).get("predict_9146_mean_ms"),
                        "predict_9146_var_ms": harness.get("protein", {}).get(
                            "predict_9146_mean_var_ms"),
                        "predict_block_eager_ms": harness.get("airfoil", {}).get(
                            "predict_block_eager_ms")})
    emit({"card": smi()})
    emit({"ok": ok, "summary": summary})
    record.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
