#!/usr/bin/env python3
"""chip_smoke.py's mesh phases: the sharded fit over a process group on
the one card, each rank a child process.

* ``mesh-nccl1``: one rank under NCCL on ``cuda:0``.  Airfoil 10-fold
  with ``setMesh`` on the host optimizer, each fold's theta bit-equal to
  the unsharded fit's (the parent's airfoil phase, handed over); the first
  fold on ``setOptimizer("device")`` sharded and unsharded, bit-equal, the
  step's all-reduce inside the captured graph.
* ``mesh-gloo2``: two ranks over gloo on the same card.  The first
  evaluation's NLL and gradient against the unsharded one; airfoil
  10-fold sharded 7 + 7 (the parent holds its RMSE to the bar and to the
  unsharded run's); gpc-mnist's ``fit_distributed``, each rank with its
  block of the training stack (8 + 8 experts); ``distribute_global_experts`` of
  unequal airfoil rows (900 / 603), its padded dims and the active set
  every rank holds.

Every rank checks its K1 launches against its own evaluations (each rank
launches K1 once an evaluation on its block), times its collectives, and
writes one JSON record.  The parent (:func:`run_mesh_phases`) starts all
three children at once, each with a timeout, kills what outlives it, and
raises on any child's failure; it needs the kernels built already.  A
child imports the port and never JAX.  Run one phase by hand from the
repo root::

    python3 -m spark_gp_tpu_torch.dev.mesh_phases
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: seconds a child may take, and the process group's own timeout
CHILD_TIMEOUT_S = 240.0
#: all-reduces timed for each payload
TIMED_REDUCES = 200


def airfoil_data():
    """Airfoil z-scored with its 10 CV folds at seed 13, as chip_smoke.py's
    ``main_path_data`` loads it."""
    from spark_gp_tpu_torch.data import load_airfoil
    from spark_gp_tpu_torch.ops.scaling import scale
    from spark_gp_tpu_torch.utils.validation import kfold_indices

    x, y = load_airfoil()
    x = scale(x)
    return x, y, list(kfold_indices(x.shape[0], 10, seed=13))


def _wrappers():
    from spark_gp_tpu_torch.ops import lane_gram as lg
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.ops import spd_linalg as spd
    from spark_gp_tpu_torch.ops import streamed_matvec as sm

    return {w.__name__: w for w in (spd.spd_inv_logdet, sm.streamed_matvec,
                                    sm.streamed_matvec_vjp, sq.slq_quadrature, lg.lane_gram)}


def _probe_k1(model) -> float:
    return float(model.metrics.get("expert_quality.probe_launches.spd_inv_logdet", 0.0))


def _reduce_ms(mesh, tensor, host: bool = False) -> float:
    """Median ms of one all-reduce of ``tensor``'s payload (the host
    objective's float64 array when ``host``), synchronized."""
    import torch

    times = []
    for _ in range(TIMED_REDUCES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if host:
            mesh.all_reduce_host(tensor)
        else:
            mesh.all_reduce(tensor)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _fold_fits(gp, x, y, folds):
    """Each fold's fit: theta, test RMSE, evaluations, the probe's K1."""
    from spark_gp_tpu_torch.utils.validation import rmse

    out = []
    for train, test in folds:
        model = gp.fit(x[train], y[train])
        pred = model.predict(x[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("mesh: predictions not finite")
        out.append({"theta": model.raw_predictor.theta.tolist(),
                    "rmse": float(rmse(y[test], pred)),
                    "nfev": int(model.metrics["lbfgs_nfev"]), "probe_k1": _probe_k1(model),
                    "num_experts": int(model.metrics["num_experts"])})
    return out


def nccl1(args: dict) -> dict:
    """mesh-nccl1 (module doc), rank 0 of 1."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.parallel import distributed as pd

    pd.initialize(f"file://{args['store']}", 1, 0, backend="nccl",
                  timeout_s=CHILD_TIMEOUT_S)
    mesh = pd.global_expert_mesh()
    x, y, folds = airfoil_data()
    w = _wrappers()
    checks, rec = {}, {"backend": mesh.backend, "world_size": mesh.world_size,
                       "device": str(mesh.device)}
    for wr in w.values():
        wr.launches = 0
    start = time.perf_counter()
    fits = _fold_fits(cs.airfoil_gp(100).setMesh(mesh), x, y, folds)
    k1_host = w["spd_inv_logdet"].launches
    rec["host"] = {"seconds": time.perf_counter() - start,
                   "rmse": float(np.mean([f["rmse"] for f in fits])),
                   "nfev": sum(f["nfev"] for f in fits), "k1": k1_host,
                   "probe_k1": sum(f["probe_k1"] for f in fits),
                   "num_experts": sorted({f["num_experts"] for f in fits})}
    checks["host_theta_bit_equal"] = all(
        f["theta"] == ref for f, ref in zip(fits, args["unsharded_thetas"]))
    checks["host_k1_rule"] = k1_host == rec["host"]["nfev"] + rec["host"]["probe_k1"] > 0
    # the first fold on the device optimizer, sharded and not
    train = folds[0][0]
    before = w["spd_inv_logdet"].launches
    t0 = time.perf_counter()
    dev = cs.airfoil_gp(100).setOptimizer("device").setMesh(mesh).fit(x[train], y[train])
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    k1_dev = w["spd_inv_logdet"].launches - before
    ref = cs.airfoil_gp(100).setOptimizer("device").fit(x[train], y[train])
    m = dev.metrics
    loop = {k: v for k, v in m.items() if k.startswith("device_opt.")}
    rec["device"] = {"seconds": dev_s, "nfev": int(m["lbfgs_nfev"]), "k1": k1_dev,
                     "probe_k1": _probe_k1(dev), "loop": loop,
                     "all_reduce_captured": bool(loop.get("device_opt.captures") == 1.0
                                                 and loop.get("device_opt.replays", 0) > 0)}
    checks["device_theta_bit_equal"] = bool(np.array_equal(dev.raw_predictor.theta,
                                                           ref.raw_predictor.theta))
    checks["device_captured"] = rec["device"]["all_reduce_captured"]
    # the device fit's rule: one K1 a replay, one for the initial evaluation
    checks["device_k1_rule"] = k1_dev == (loop["device_opt.replays"]
                                          + loop.get("device_opt.eager_steps", 0.0) + 1
                                          + rec["device"]["probe_k1"])
    h = len(ref.raw_predictor.theta)
    rec["all_reduce_ms"] = {
        "device_step_payload": _reduce_ms(mesh, torch.zeros((1, 1 + h), device=mesh.device)),
        "host_objective_payload": _reduce_ms(mesh, np.zeros(1 + h), host=True)}
    rec["payload_bytes"] = {"device_step": 4 * (1 + h), "host_objective": 8 * (1 + h),
                            "u1_u2": 8 * (1000 * 1000 + 1000)}
    rec["launches"] = {n: wr.launches for n, wr in w.items()}
    rec["checks"] = checks
    return rec


def gloo2(args: dict) -> dict:
    """mesh-gloo2 (module doc), one of two ranks."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.models.likelihood import (
        make_sharded_value_and_grad,
        make_value_and_grad,
    )
    from spark_gp_tpu_torch.parallel import distributed as pd
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.parallel.mesh import shard_experts
    from spark_gp_tpu_torch.utils.validation import accuracy

    rank = int(args["rank"])
    pd.initialize(f"file://{args['store']}", 2, rank, backend="gloo", timeout_s=CHILD_TIMEOUT_S)
    mesh = pd.global_expert_mesh()   # the card, by the port's rule, under gloo too
    if mesh.device.type != "cuda":
        raise AssertionError(f"mesh-gloo2: the mesh's default device is {mesh.device}")
    x, y, folds = airfoil_data()
    w = _wrappers()
    checks, rec = {}, {"backend": mesh.backend, "world_size": mesh.world_size, "rank": rank,
                       "device": str(mesh.device)}
    # the first evaluation, sharded against unsharded, at the initial theta
    train = folds[0][0]
    kernel = cs.airfoil_gp(100)._get_kernel()
    theta0 = kernel.init_theta()
    whole = group_for_experts(x[train], y[train], 100, dtype=torch.float32, device="cuda")
    v1, g1 = make_value_and_grad(kernel, whole)(theta0)
    v2, g2 = make_sharded_value_and_grad(kernel, shard_experts(whole, mesh), mesh)(theta0)
    dv = abs(v2 - v1) / abs(v1)
    dg = float(np.max(np.abs(g2 - g1)) / np.max(np.abs(g1)))
    rec["first_evaluation"] = {"rel_value_err": dv, "rel_grad_err": dg,
                               "block": list(shard_experts(whole, mesh).x.shape)}
    checks["first_evaluation"] = dv < 1e-5 and dg < 1e-4
    for wr in w.values():
        wr.launches = 0
    # airfoil 10-fold, 7 + 7 experts a fold
    start = time.perf_counter()
    fits = _fold_fits(cs.airfoil_gp(100).setMesh(mesh), x, y, folds)
    k1 = w["spd_inv_logdet"].launches
    rec["airfoil"] = {"seconds": time.perf_counter() - start,
                      "rmse": float(np.mean([f["rmse"] for f in fits])),
                      "nfev": sum(f["nfev"] for f in fits), "k1": k1,
                      "probe_k1": sum(f["probe_k1"] for f in fits),
                      "thetas": [f["theta"] for f in fits],
                      "num_experts": sorted({f["num_experts"] for f in fits})}
    checks["airfoil_k1_rule"] = k1 == rec["airfoil"]["nfev"] + rec["airfoil"]["probe_k1"] > 0
    # gpc-mnist by fit_distributed: each rank holds its block of the
    # training stack (8 + 8 experts)
    from spark_gp_tpu_torch.models import laplace as lap

    cdata = cs.classifier_data()
    xm, ym, tr = cdata["xm"], cdata["ym"], cdata["tr_m"]
    te = np.setdiff1d(np.arange(xm.shape[0]), tr)
    before = w["spd_inv_logdet"].launches
    iters, calls = lap.laplace_mode_batch.iterations, lap.batched_neg_logz.calls
    start = time.perf_counter()
    data = shard_experts(group_for_experts(xm[tr], ym[tr], 100, dtype=torch.float32,
                                           device=mesh.device), mesh)
    gmodel = cs.mnist_gpc().fit_distributed(data)
    acc = float(accuracy(ym[te], gmodel.predict(xm[te])))
    g = gmodel.metrics
    k1_g = w["spd_inv_logdet"].launches - before
    rec["gpc_mnist"] = {"seconds": time.perf_counter() - start, "accuracy": acc,
                        "block": list(data.x.shape), "num_experts": int(g["num_experts"]),
                        "nfev": int(g["lbfgs_nfev"]),
                        "newton_iterations": lap.laplace_mode_batch.iterations - iters,
                        "objective_calls": lap.batched_neg_logz.calls - calls,
                        "k1": k1_g, "probe_k1": _probe_k1(gmodel),
                        "theta": gmodel.raw_predictor.theta.tolist()}
    checks["gpc_mnist_accuracy"] = acc > 0.84
    # the binary Laplace rule: one K1 a Newton iteration and one a call,
    # this rank's own Newton iterations
    checks["gpc_mnist_k1_rule"] = k1_g == (rec["gpc_mnist"]["newton_iterations"]
                                           + rec["gpc_mnist"]["objective_calls"]
                                           + rec["gpc_mnist"]["probe_k1"])
    # distribute_global_experts of unequal rows, and the fit from it
    rows = (slice(0, 900), slice(900, 1503))[rank]
    local = group_for_experts(x[rows], y[rows], 100)
    data = pd.distribute_global_experts(x[rows], y[rows], 100, mesh)
    dims = mesh.all_gather(torch.tensor([local.num_experts, local.expert_size],
                                        device=mesh.device))
    want = tuple(int(v) for v in torch.stack(dims).max(dim=0).values.cpu())
    before = w["spd_inv_logdet"].launches
    dmodel = cs.airfoil_gp(100).fit_distributed(data)
    active = np.asarray(dmodel.raw_predictor.active, dtype=np.float64)
    rec["distribute"] = {"local_dims": [local.num_experts, local.expert_size],
                         "padded_dims": list(data.x.shape[:2]), "pad_stack_dims": list(want),
                         "active_digest": float(np.sum(active * np.arange(1, active.size + 1)
                                                       .reshape(active.shape))),
                         "active_rows": int(active.shape[0]),
                         "nfev": int(dmodel.metrics["lbfgs_nfev"]),
                         "k1": w["spd_inv_logdet"].launches - before,
                         "probe_k1": _probe_k1(dmodel),
                         "theta": dmodel.raw_predictor.theta.tolist()}
    checks["distribute_dims"] = tuple(data.x.shape[:2]) == want
    checks["distribute_k1_rule"] = rec["distribute"]["k1"] == (rec["distribute"]["nfev"]
                                                               + rec["distribute"]["probe_k1"])
    h = len(theta0)
    u1 = torch.zeros((1000, 1000), dtype=torch.float64, device=mesh.device)
    rec["all_reduce_ms"] = {
        "host_objective_payload": _reduce_ms(mesh, np.zeros(1 + h), host=True),
        "u1": _reduce_ms(mesh, u1)}
    rec["payload_bytes"] = {"host_objective": 8 * (1 + h), "u1": 8 * 1000 * 1000}
    rec["launches"] = {n: wr.launches for n, wr in w.items()}
    rec["checks"] = checks
    return rec


def child_main(argv) -> int:
    """``<phase> <args.json> <out.json>``: run one rank, write its record."""
    phase, args_path, out_path = argv
    with open(args_path, encoding="utf-8") as fh:
        args = json.load(fh)
    start = time.perf_counter()
    rec = {"nccl1": nccl1, "gloo2": gloo2}[phase](args)
    rec["seconds"] = time.perf_counter() - start
    import torch.distributed as dist

    dist.destroy_process_group()
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(rec, fh)
    return 0


def run_mesh_phases(unsharded_thetas, timeout_s: float = CHILD_TIMEOUT_S) -> dict:
    """Start the three ranks (mesh-nccl1's and mesh-gloo2's two) at once,
    each with ``timeout_s``; return ``{"nccl1": record, "gloo2": [rank 0,
    rank 1], "seconds": wall}``.  Raises naming the child that failed,
    timed out or wrote no record (its output's tail in the message), after
    every child has ended."""
    work = tempfile.mkdtemp(prefix="gp_mesh_")
    jobs = []
    for phase, rank in (("nccl1", 0), ("gloo2", 0), ("gloo2", 1)):
        args = {"rank": rank, "store": os.path.join(work, f"{phase}.store"),
                "unsharded_thetas": unsharded_thetas}
        args_path = os.path.join(work, f"{phase}-{rank}.args.json")
        with open(args_path, "w", encoding="utf-8") as fh:
            json.dump(args, fh)
        out_path = os.path.join(work, f"{phase}-{rank}.json")
        log = open(os.path.join(work, f"{phase}-{rank}.log"), "w+", encoding="utf-8")
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_gp_tpu_torch.dev.mesh_phases", phase, args_path,
             out_path], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((phase, rank, proc, out_path, log))
    start = time.perf_counter()
    failures = []
    for phase, rank, proc, out_path, log in jobs:
        left = max(1.0, timeout_s - (time.perf_counter() - start))
        try:
            proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failures.append(f"{phase} rank {rank}: timed out after {timeout_s} s")
        if proc.returncode != 0 or not os.path.exists(out_path):
            log.seek(0)
            failures.append(f"{phase} rank {rank}: exit {proc.returncode}\n"
                            + log.read()[-3000:])
        log.close()
    if failures:
        raise AssertionError("mesh phases failed:\n" + "\n".join(failures))
    recs = {}
    for phase, rank, _, out_path, _ in jobs:
        with open(out_path, encoding="utf-8") as fh:
            recs.setdefault(phase, []).append(json.load(fh))
    return {"nccl1": recs["nccl1"][0], "gloo2": recs["gloo2"],
            "seconds": time.perf_counter() - start}


def main() -> int:
    """By hand: build the kernels, fit the unsharded airfoil folds, run
    the mesh phases and print their records."""
    import torch

    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.ops import cuda_lib

    cuda_lib.build_all(["spd_inv_logdet", "streamed_matvec", "slq_quadrature", "lane_gram"])
    x, y, folds = airfoil_data()
    cv = cs.regression_cv(cs.airfoil_gp(100), x, y, folds)
    out = run_mesh_phases([f["theta"] for f in cv["per_fold"]])
    out["unsharded_rmse"] = cv["rmse"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:]) if len(sys.argv) == 4 else main())
