#!/usr/bin/env python3
"""chip_smoke.py's mesh phases: the sharded fit over a process group on
the one card, each rank a child process.

* ``mesh-nccl1``: one rank under NCCL on ``cuda:0``.  Airfoil 10-fold
  with ``setMesh`` on the host optimizer, each fold's theta bit-equal to
  the unsharded fit's (the parent's airfoil phase, handed over); the first
  fold on ``setOptimizer("device")`` sharded and unsharded, bit-equal, the
  step's all-reduce inside the captured graph.  Then the same pairs for
  the device fits of the binary Laplace (gpc-mnist), the native
  multiclass (iris, fold 0), Poisson (quality.py's) and EP (iris, fold 0,
  setosa against the rest), each step's all-reduce captured (graph nodes
  beside the unsharded step's); the ELBO fit of the Synthetics objectives
  split on both optimizers; the selection phase's config under
  ``GP_AGG_SELECT=1``.
* ``mesh-gloo2``: two ranks over gloo on the same card.  The first
  evaluation's NLL and gradient against the unsharded one; airfoil
  10-fold sharded 7 + 7 (the parent holds its RMSE to the bar and to the
  unsharded run's); gpc-mnist's ``fit_distributed``, each rank with its
  block of the training stack (8 + 8 experts); ``distribute_global_experts`` of
  unequal airfoil rows (900 / 603), its padded dims and the active set
  every rank holds.  Then the ELBO's first evaluation against the
  unsharded one and its host fit's RMSE against the unsharded fit's; the
  selection config's dropped set and weights against the single-process
  selection's; the row-sharded magic solve at the large-m config's fitted
  theta and active set (m = 4096; ``(U1, u2)`` from each rank's half of
  the rows), held to chip_smoke's device-against-host bars against the
  one-rank device solve of the same statistics, its panel checks counted
  and a staged ``corrupt_device(1)`` raising ``PanelMismatchError``
  naming rank 1 on both ranks.
* the coordination plane (``parallel/coord.py``; :func:`coord_gloo2`,
  :func:`coord_nccl1`).  mesh-gloo2: airfoil fold 0 again in the
  key-value-store mode (``GP_DCN_MODE=1``: every sum a round over the
  group's ``FileStore``, no gloo collective), theta bit-equal on both
  ranks, RMSE < 2.1 and within 1e-6 of the gloo-sharded fold, K1 once an
  evaluation; the same fold with every evaluation audited by duplicate
  dispatch (``GP_INTEGRITY_DUPCHECK_P=1``: each audit one K1 launch a
  rank and one more on its target), every audit passing and its rung
  recorded; ``corrupt_host(1, "bitflip", op="vag")`` raising
  ``AttestationError`` naming rank 1 on both ranks; a coordinated host
  checkpoint under the gloo mesh with a preemption staged on rank 1
  (both ranks stop with ``PreemptedError`` at the same save, the resume
  ends at the uninterrupted fold's theta; rank 0 keeps a copy of the
  checkpoint the preemption left, from which the parent resumes the fold
  in one process: an elastic resume that runs most of the fit live); and,
  after the ranks
  wrote their records, rank 1 dies before a guarded step
  (``DeadHost(exit_process=True)``, exit 137) while rank 0, at
  ``GP_COORD_TIMEOUT_S=5``, raises ``CoordinationTimeoutError`` naming
  it.  mesh-nccl1: fold 0's device fit with ``setCheckpointDir`` under
  the mesh (segmented, the coordinated device shell at world size 1)
  bit-equal to the same segmented fit without it, the all-reduce still
  captured, and a staged preemption plus resume at the same theta.

Every rank checks its K1 launches against its own evaluations (each rank
launches K1 once an evaluation on its block), times its collectives, and
writes one JSON record.  Beside them, by hand only, ``--cards N`` runs
mesh-cards: one rank a card under NCCL (a call with N chips), the
large-m magic solve row-sharded over the cards against one card's device
solve, and gpc-mnist's device fit over the cards.  The parent (:func:`run_mesh_phases`) starts all
three children at once, each with a timeout, kills what outlives it, and
raises on any child's failure; it needs the kernels built already.  A
child imports the port and never JAX.  Run the phases by hand from the
repo root::

    python3 -m spark_gp_tpu_torch.dev.mesh_phases
    python3 -m spark_gp_tpu_torch.dev.mesh_phases --cards 4
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

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
    rec["slice17"] = slice17_nccl1(mesh, w, checks)
    rec["coord"] = coord_nccl1(mesh, w, checks, x, y, folds, args["ckpt_dir"])
    rec["launches"] = {n: wr.launches for n, wr in w.items()}
    rec["checks"] = checks
    return rec


def _same_model(a, b, xt) -> bool:
    """Two fits' theta, magic vector and predictions at ``xt`` bit-equal."""
    ra, rb = a.raw_predictor, b.raw_predictor
    return bool(np.array_equal(ra.theta, rb.theta)
                and np.array_equal(ra.magic_vector, rb.magic_vector)
                and np.array_equal(ra.predict_mean(xt).cpu().numpy(),
                                   rb.predict_mean(xt).cpu().numpy()))


def _pair(make, x, y, mesh):
    """``make()``'s fit over ``mesh`` and without it, on the same rows, with
    the seconds of each."""
    t0 = time.perf_counter()
    sharded = make().setMesh(mesh).fit(x, y)
    t1 = time.perf_counter()
    alone = make().fit(x, y)
    return sharded, alone, {"sharded": t1 - t0, "unsharded": time.perf_counter() - t1}


def _selected(env: dict, make):
    """``make()`` with ``env`` set around it, the environment restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return make()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def slice17_nccl1(mesh, w: dict, checks: dict) -> dict:
    """mesh-nccl1's latent, ELBO and selection pairs (module doc), each
    pair's K1 launches held to its rule; ``checks`` gains one entry a
    pair."""
    import chip_smoke as cs

    cdata, d6, rdata, d7 = cs.classifier_data(), cs.poisson_data(), cs.regression_data(), \
        cs.slice7_data()
    xm, ym, tr = cdata["xm"], cdata["ym"], cdata["tr_m"]
    train_i = cdata["folds_i"][0][0]
    xi, yi = cdata["xi"][train_i], cdata["yi"][train_i]
    xs, ys = rdata["x"][rdata["tr"]], rdata["y"][rdata["tr"]]
    select = {"GP_AGG_SELECT": "1"}
    latent = cs.latent_k1_rule
    pairs = {
        "gpc_mnist": (lambda: cs.mnist_gpc().setOptimizer("device"), xm[tr], ym[tr], latent),
        "iris_native": (lambda: cs.iris_native_gpc().setOptimizer("device"), xi, yi, latent),
        "poisson": (lambda: cs.poisson_gp().setOptimizer("device"), d6["x"], d6["y"], latent),
        # EP's rule: the Laplace step's and one K1 launch for the posterior mean
        "iris_ep": (lambda: cs.ep_gpc().setOptimizer("device"), xi, (yi == 0).astype(float),
                    lambda m: latent(m) + 1),
        "elbo_host": (lambda: cs.synthetics_gp("elbo"), xs, ys, cs.probe_rule),
        "elbo_device": (lambda: cs.synthetics_gp("elbo").setOptimizer("device"), xs, ys,
                        cs.probe_rule),
        "selection": (lambda: _selected(select, cs.selection_gp), d7["x_sel"], d7["y_sel"],
                      lambda m: m["lbfgs_nfev"] + cs.probe_rule(m)),
    }
    out = {}
    for name, (make, x, y, rule) in pairs.items():
        before = w["spd_inv_logdet"].launches
        if name == "selection":
            sharded, alone, seconds = _selected(select, lambda: _pair(make, x, y, mesh))
        else:
            sharded, alone, seconds = _pair(make, x, y, mesh)
        k1 = w["spd_inv_logdet"].launches - before
        ms, ma = sharded.metrics, alone.metrics
        row = {"seconds": seconds, "nfev": [ms["lbfgs_nfev"], ma["lbfgs_nfev"]], "k1": k1,
               "k1_rule": rule(ms) + rule(ma), "bit_equal": _same_model(sharded, alone, x[:200])}
        if "device_opt.graph_nodes" in ms:
            row["graph_nodes"] = [ms["device_opt.graph_nodes"], ma["device_opt.graph_nodes"]]
            row["captured"] = ms.get("device_opt.captures") == 1.0 and \
                ms.get("device_opt.replays", 0.0) > 0
        if name == "selection":
            row["dropped"] = [ms["agg.selection_dropped"], ma["agg.selection_dropped"]]
        out[name] = row
        checks[f"{name}_bit_equal"] = row["bit_equal"]
        checks[f"{name}_k1_rule"] = k1 == row["k1_rule"]
        if "graph_nodes" in row:
            # the step's one all-reduce: a few nodes over the unsharded step
            extra = row["graph_nodes"][0] - row["graph_nodes"][1]
            checks[f"{name}_all_reduce_captured"] = row["captured"] and 0 < extra <= 16
        if name == "selection":
            checks["selection_dropped"] = row["dropped"][0] == row["dropped"][1] > 0
    return out


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
    rec["slice17"] = slice17_gloo2(mesh, w, checks, args["large_m"])
    rec["coord"] = coord_gloo2(mesh, w, checks, x, y, folds, fits[0], args["ckpt_dir"])
    rec["launches"] = {n: wr.launches for n, wr in w.items()}
    rec["checks"] = checks
    return rec


def slice17_gloo2(mesh, w: dict, checks: dict, large_m: dict) -> dict:
    """mesh-gloo2's ELBO, selection and sharded magic solve (module doc);
    ``checks`` gains their entries."""
    import torch

    import chip_smoke as cs
    from spark_gp_tpu_torch.models.likelihood import (
        make_sharded_value_and_grad,
        make_value_and_grad,
    )
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.parallel.mesh import shard_experts
    from spark_gp_tpu_torch.utils.validation import rmse

    out = {}
    rdata = cs.regression_data()
    xs, ys = rdata["x"][rdata["tr"]], rdata["y"][rdata["tr"]]
    xe, ye = rdata["x"][rdata["te"]], rdata["y"][rdata["te"]]
    # the ELBO's first evaluation, sharded against unsharded, at the
    # initial theta over 100 seeded rows
    gp = cs.synthetics_gp("elbo")
    kernel, sigma2 = gp._get_kernel(), gp._sigma2
    active = xs[np.random.default_rng(13).choice(xs.shape[0], 100, replace=False)]
    whole = group_for_experts(xs, ys, 100, dtype=torch.float32, device=mesh.device)
    extra = (active, sigma2)
    v1, g1 = make_value_and_grad(kernel, whole, None, "elbo", extra)(kernel.init_theta())
    v2, g2 = make_sharded_value_and_grad(kernel, shard_experts(whole, mesh), mesh, "elbo",
                                         extra=extra)(kernel.init_theta())
    first = {"rel_value_err": abs(v2 - v1) / abs(v1),
             "rel_grad_err": float(np.max(np.abs(g2 - g1)) / np.max(np.abs(g1)))}
    checks["elbo_first_evaluation"] = first["rel_value_err"] <= 1e-6 and \
        first["rel_grad_err"] <= 1e-7
    # the ELBO's host fit, sharded and not: RMSE within 1%
    before = w["spd_inv_logdet"].launches
    sharded, alone, seconds = _pair(lambda: cs.synthetics_gp("elbo"), xs, ys, mesh)
    scores = [float(rmse(ye, m.predict(xe))) for m in (sharded, alone)]
    k1 = w["spd_inv_logdet"].launches - before
    out["elbo"] = {"first_evaluation": first, "rmse": scores, "seconds": seconds,
                   "nfev": [sharded.metrics["lbfgs_nfev"], alone.metrics["lbfgs_nfev"]],
                   "k1": k1}
    checks["elbo_rmse_within_1pct"] = abs(scores[0] - scores[1]) <= 0.01 * scores[1]
    checks["elbo_k1_rule"] = k1 == cs.probe_rule(sharded.metrics) + cs.probe_rule(alone.metrics)
    # the selection config: the same dropped set and weights as the
    # selection in one process
    d7 = cs.slice7_data()
    before = w["spd_inv_logdet"].launches
    sharded, alone, seconds = _selected(
        {"GP_AGG_SELECT": "1"}, lambda: _pair(cs.selection_gp, d7["x_sel"], d7["y_sel"], mesh))
    k1 = w["spd_inv_logdet"].launches - before
    ms, ma = sharded.metrics, alone.metrics
    out["selection"] = {"dropped": [ms["agg.selection_dropped"], ma["agg.selection_dropped"]],
                        "renorm": [ms["agg.renorm"], ma["agg.renorm"]],
                        "weights": sharded.instr.agg_weights.tolist(), "seconds": seconds,
                        "nfev": [ms["lbfgs_nfev"], ma["lbfgs_nfev"]], "k1": k1}
    checks["selection_same_report"] = (
        ms["agg.selection_dropped"] == ma["agg.selection_dropped"] > 0
        and ms["agg.renorm"] == ma["agg.renorm"]
        and np.array_equal(sharded.instr.agg_weights, alone.instr.agg_weights))
    # each rank launches K1 once an evaluation on its own block
    checks["selection_k1_rule"] = k1 == (ms["lbfgs_nfev"] + cs.probe_rule(ms)
                                         + ma["lbfgs_nfev"] + cs.probe_rule(ma))
    out["magic_solve"] = sharded_solve(mesh, checks, large_m)
    return out


def _fold_rmse(model, x, y, test) -> float:
    from spark_gp_tpu_torch.utils.validation import rmse

    return float(rmse(y[test], model.predict(x[test])))


def _audited_k1(first: int, nfev: int, audits: int, rank: int, world: int, p: float) -> int:
    """K1 launches of a store-mode host fit's audits on ``rank``: every
    audited vag round (``integrity.should_spot_check`` of the context's
    round index, from ``first``) recomputes one expert claim on every rank
    and the target computes its claim too."""
    from spark_gp_tpu_torch.resilience import integrity

    rounds = [k for k in range(first, first + nfev) if integrity.should_spot_check(k, p)]
    if len(rounds) != audits:
        return -1
    return len(rounds) + sum(integrity.spot_check_target(k, world) == rank for k in rounds)


def coord_gloo2(mesh, w: dict, checks: dict, x, y, folds, fold0: dict, ckpt_dir: str) -> dict:
    """mesh-gloo2's coordination phases (module doc), fold 0; ``fold0`` is
    the gloo-sharded fold's record; ``checks`` gains their entries."""
    import json

    import chip_smoke as cs
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.parallel import coord
    from spark_gp_tpu_torch.resilience import chaos, integrity

    train, test = folds[0]
    out = {}
    k1 = w["spd_inv_logdet"]

    def counter(key):
        return telemetry.snapshot()["counters"].get(key, 0.0)

    def store_fit(p):
        """The fold in the store mode with audits at rate ``p``: its record."""
        with_env = {"GP_DCN_MODE": "1", "GP_INTEGRITY_DUPCHECK_P": str(p)}
        ctx = _selected(with_env, coord.dcn_context)
        rounds, audits, before = dict(ctx.gathers), len(ctx.audits), k1.launches
        first = ctx.gathers.get("vag", 0)
        t0 = time.perf_counter()
        model = _selected(with_env, lambda: cs.airfoil_gp(100).setMesh(mesh).fit(x[train],
                                                                                  y[train]))
        seconds = time.perf_counter() - t0
        m = model.metrics
        nfev, probe = int(m["lbfgs_nfev"]), _probe_k1(model)
        new_audits = list(ctx.audits[audits:])
        return {"seconds": seconds, "nfev": nfev, "theta": model.raw_predictor.theta.tolist(),
                "rmse": _fold_rmse(model, x, y, test), "k1": k1.launches - before,
                "probe_k1": probe,
                "k1_rule": nfev + probe + _audited_k1(first, nfev, len(new_audits), mesh.rank,
                                                      mesh.world_size, p),
                "audits": len(new_audits), "audit_rungs": sorted({str(r) for r in new_audits}),
                "store_rounds": {k: v - rounds.get(k, 0) for k, v in ctx.gathers.items()
                                 if v - rounds.get(k, 0)}}

    rec = store_fit(0.0)
    ctx = _selected({"GP_DCN_MODE": "1"}, coord.dcn_context)
    h = len(rec["theta"])
    times = []
    for _ in range(TIMED_REDUCES):
        t0 = time.perf_counter()
        ctx.allreduce_arrays("timed_vag", np.zeros(1), np.zeros(h), np.zeros(1))
        times.append((time.perf_counter() - t0) * 1e3)
    rec["round_trip_ms"] = float(np.median(times))
    rec["round_trip_payload_bytes"] = 8 * (h + 2)
    out["store_fit"] = rec
    checks["store_fit_rmse"] = rec["rmse"] < 2.1
    checks["store_fit_vs_gloo"] = abs(rec["rmse"] - fold0["rmse"]) <= 1e-6 * fold0["rmse"]
    checks["store_fit_k1_rule"] = rec["k1"] == rec["k1_rule"] > 0
    # every evaluation audited by duplicate dispatch
    audited = store_fit(1.0)
    out["audited_fit"] = audited
    checks["audits_pass"] = audited["audits"] == audited["nfev"] > 0 and \
        "None" not in audited["audit_rungs"]
    checks["audited_k1_rule"] = audited["k1"] == audited["k1_rule"] > 0
    # a bit flip on rank 1's published vag payloads
    verdict = None
    t0 = time.perf_counter()
    try:
        with chaos.corrupt_host(1, "bitflip", op="vag"):
            _selected({"GP_DCN_MODE": "1", "GP_INTEGRITY_DUPCHECK_P": "0"},
                      lambda: cs.airfoil_gp(100).setMesh(mesh).fit(x[train], y[train]))
    except integrity.AttestationError as exc:
        verdict = {"type": type(exc).__name__, "pid": exc.pid, "code": exc.code}
    out["corrupt_host"] = {"verdict": verdict, "seconds": time.perf_counter() - t0}
    checks["corrupt_host_named"] = verdict is not None and verdict["pid"] == 1 \
        and verdict["code"] == "digest_mismatch"
    # a coordinated host checkpoint under the gloo mesh, rank 1 preempted
    directory = os.path.join(ckpt_dir, "gloo2_host")
    saves0, before = counter("coord.checkpoints"), k1.launches
    raised = None
    if mesh.rank == 1:
        chaos.stage_preemption(True)
    try:
        cs.airfoil_gp(100).setMesh(mesh).setCheckpointDir(directory).fit(x[train], y[train])
    except coord.PreemptedError as exc:
        raised = type(exc).__name__
    finally:
        chaos.stage_preemption(False)
        coord.clear_preemption_for_testing()
    with open(os.path.join(directory, "lbfgs_state_GaussianProcessRegression.json")) as fh:
        saved = json.load(fh)
    preempted_evals = len(saved["evaluations"])
    # the preempted checkpoint, kept for the parent's elastic resume (rank 0
    # is the writer: the ranks' resume below overwrites the original)
    preempted_copy = directory + "_preempted"
    if mesh.rank == 0:
        shutil.copytree(directory, preempted_copy)
    resumed = cs.airfoil_gp(100).setMesh(mesh).setCheckpointDir(directory).fit(x[train],
                                                                            y[train])
    m = resumed.metrics
    out["preemption"] = {
        "raised": raised, "saved_iteration": saved["iteration"],
        "checkpoints": counter("coord.checkpoints") - saves0,
        "preempted_evaluations": preempted_evals, "resumed_nfev": int(m["lbfgs_nfev"]),
        "resumed_from_iteration": m.get("resumed_from_iteration", 0),
        "k1": k1.launches - before,
        "k1_rule": preempted_evals + int(m["lbfgs_nfev"]) + _probe_k1(resumed),
        "theta": resumed.raw_predictor.theta.tolist(), "final_nll": m["final_nll"],
        "rmse": _fold_rmse(resumed, x, y, test), "preempted_copy": preempted_copy,
        "elastic_process_count": saved.get("elastic", {}).get("process_count")}
    checks["preemption_stops"] = raised == "PreemptedError" and saved["iteration"] == 1
    out["preemption"]["bit_equal"] = out["preemption"]["theta"] == fold0["theta"]
    checks["preemption_resume_theta"] = _rel_diff(out["preemption"]["theta"],
                                                  fold0["theta"]) <= 1e-9
    checks["preemption_k1_rule"] = out["preemption"]["k1"] == out["preemption"]["k1_rule"]
    return out


def dead_rank(rank: int, timeout_s: float = 5.0) -> Optional[dict]:
    """The last gloo2 step, after the ranks wrote their records: rank 1
    dies before a guarded step (exit 137); rank 0 meets the deadline and
    returns what it raised."""
    from spark_gp_tpu_torch.parallel import coord
    from spark_gp_tpu_torch.resilience import chaos

    if rank == 1:
        with chaos.DeadHost(exit_process=True):
            coord.guard_collective("dead-rank")
        return None  # not reached
    os.environ["GP_COORD_TIMEOUT_S"] = str(timeout_s)
    t0 = time.perf_counter()
    try:
        coord.guard_collective("dead-rank")
    except coord.CoordinationTimeoutError as exc:
        return {"missing": list(exc.missing), "seconds": time.perf_counter() - t0,
                "timeout_s": timeout_s}
    return {"missing": [], "seconds": time.perf_counter() - t0, "timeout_s": timeout_s}


def coord_nccl1(mesh, w: dict, checks: dict, x, y, folds, ckpt_dir: str) -> dict:
    """mesh-nccl1's coordinated device checkpoint (module doc), fold 0;
    ``checks`` gains its entries."""
    import chip_smoke as cs
    from spark_gp_tpu_torch.parallel import coord
    from spark_gp_tpu_torch.resilience import chaos

    train = folds[0][0]
    k1 = w["spd_inv_logdet"]

    def fit(name, with_mesh):
        gp = cs.airfoil_gp(100).setOptimizer("device").setCheckpointDir(
            os.path.join(ckpt_dir, name))
        return (gp.setMesh(mesh) if with_mesh else gp).fit(x[train], y[train])

    before = k1.launches
    t0 = time.perf_counter()
    meshed = fit("nccl1_mesh", True)
    t1 = time.perf_counter()
    alone = fit("nccl1_alone", False)
    seconds = {"sharded": t1 - t0, "unsharded": time.perf_counter() - t1}
    ms, ma = meshed.metrics, alone.metrics

    def device_rule(model):
        m = model.metrics
        return m["device_opt.replays"] + m.get("device_opt.eager_steps", 0.0) + 1 + \
            _probe_k1(model)

    rec = {"seconds": seconds, "k1": k1.launches - before,
           "k1_rule": device_rule(meshed) + device_rule(alone),
           "graph_nodes": [ms.get("device_opt.graph_nodes"), ma.get("device_opt.graph_nodes")],
           "captures": [ms.get("device_opt.captures"), ma.get("device_opt.captures")],
           "replays": [ms.get("device_opt.replays"), ma.get("device_opt.replays")],
           "bit_equal": _same_model(meshed, alone, x[:200])}
    checks["ckpt_device_bit_equal"] = rec["bit_equal"]
    extra = (rec["graph_nodes"][0] or 0) - (rec["graph_nodes"][1] or 0)
    checks["ckpt_device_all_reduce_captured"] = ms.get("device_opt.captures") == 1.0 \
        and ms.get("device_opt.replays", 0) > 0 and 0 < extra <= 16
    checks["ckpt_device_k1_rule"] = rec["k1"] == rec["k1_rule"]
    # a staged preemption at the first segment save, then the resume
    raised = None
    chaos.stage_preemption(True)
    try:
        fit("nccl1_preempt", True)
    except coord.PreemptedError as exc:
        raised = type(exc).__name__
    finally:
        chaos.stage_preemption(False)
        coord.clear_preemption_for_testing()
    resumed = fit("nccl1_preempt", True)
    rec["preemption"] = {"raised": raised,
                         "resumed_from_iteration": resumed.metrics.get("resumed_from_iteration",
                                                                       0),
                         "bit_equal": _same_model(resumed, meshed, x[:200]),
                         "max_rel_theta_diff": _rel_diff(resumed.raw_predictor.theta,
                                                         meshed.raw_predictor.theta)}
    checks["ckpt_device_preemption"] = raised == "PreemptedError" and \
        rec["preemption"]["resumed_from_iteration"] > 0 and \
        rec["preemption"]["max_rel_theta_diff"] <= 1e-6
    return rec


def _rel_diff(a, b) -> float:
    """The largest relative difference of two thetas."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def sharded_solve(mesh, checks: dict, large_m: dict) -> dict:
    """The row-sharded magic solve at the large-m fit's theta and active set
    against the one-rank device solve of the same statistics (module
    doc), held to chip_smoke's ``MAGIC_SOLVE_BARS``; then the tripwire's
    staged corruption.  Both ranks compute the reference solve (the card
    is shared, so their seconds are a record, not a bar)."""
    import torch

    import chip_smoke as cs
    from spark_gp_tpu_torch.models import ppa
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.ops import dist_linalg as dl
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.parallel.mesh import shard_experts
    from spark_gp_tpu_torch.resilience import chaos, integrity

    x, y = cs.large_m_data()
    kernel = cs.large_m_gp()._get_kernel()
    theta, active = np.asarray(large_m["theta"]), np.asarray(large_m["active"])
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=mesh.device)
    data = shard_experts(group_for_experts(x, y, 100, dtype=torch.float64, device=mesh.device),
                         mesh)
    u1, u2 = ppa.kmn_stats_sharded(kernel, mesh, dev(theta), dev(active), data)
    counter = lambda: telemetry.snapshot()["counters"].get("integrity.panel_checks", 0.0)
    before = counter()
    got = {}
    seconds = {
        "sharded": cs.solve_seconds(torch, lambda: got.setdefault(
            "sharded", ppa.sharded_magic_solve(kernel, theta, active, u1, u2, mesh))),
        "device": cs.solve_seconds(torch, lambda: got.setdefault(
            "device", ppa.magic_solve_device(kernel, theta, active, u1, u2,
                                             device=mesh.device)))}
    panel_checks = counter() - before
    # the honest copies' largest relative difference: 0 when every rank
    # received the all-reduced block bit for bit
    spread = telemetry.snapshot()["gauges"]["integrity.panel_spread"]
    # the factorizations of the solve (PD and K_mm at tau = 0; a jitter
    # rung refactors) times the panels sampled at the default rate
    per_factor = sum(integrity.panel_checked(k) for k in range(cs.LARGE_M // 128))
    # the MAGIC_SOLVE_BARS quantities on the first 2,000 rows
    theta64, act64, xq = dev(theta), dev(active), dev(x[:2000])
    cross = kernel.cross(theta64, xq, act64)
    prior = kernel.self_diag(theta64, xq)
    pd = kernel.white_noise_var(theta64) * kernel.gram(theta64, act64) + u1

    def residual(mv):
        mv = dev(mv)
        return float(torch.linalg.vector_norm(pd @ mv - u2)
                     / (torch.linalg.matrix_norm(pd, 2) * torch.linalg.vector_norm(mv)))

    (s_mv, s_mm), (d_mv, d_mm) = got["sharded"], got["device"]
    means = [(cross @ dev(mv)).cpu().numpy() for mv in (s_mv, d_mv)]
    variances = [(prior + torch.einsum("tm,mk,tk->t", cross, dev(mm), cross)).cpu().numpy()
                 for mm in (s_mm, d_mm)]
    errs = {"residual_sharded": residual(s_mv), "residual_device": residual(d_mv),
            "mean": float(np.abs(means[0] - means[1]).max() / np.abs(means[1]).max()),
            "variance": float(np.abs(variances[0] - variances[1]).max() / float(prior.max())),
            "magic_vector_no_bar": float(np.abs(s_mv - d_mv).max() / np.abs(d_mv).max()),
            "magic_matrix_no_bar": float(np.abs(s_mm - d_mm).max() / np.abs(d_mm).max())}
    bars = cs.MAGIC_SOLVE_BARS
    checks["magic_solve_bars"] = (errs["residual_sharded"] <= bars["residual_device"]
                                  and errs["residual_device"] <= bars["residual_device"]
                                  and errs["mean"] <= bars["mean"]
                                  and errs["variance"] <= bars["variance"])
    checks["magic_solve_panel_checks"] = panel_checks >= 2 * per_factor > 0 and \
        panel_checks % per_factor == 0 and spread == 0.0
    # the tripwire: rank 1's panel copies scaled, named on both ranks
    t0 = time.perf_counter()
    verdict = None
    try:
        with chaos.corrupt_device(1):
            ppa.sharded_magic_solve(kernel, theta, active, u1, u2, mesh)
    except integrity.PanelMismatchError as exc:
        verdict = {"pid": exc.pid, "code": exc.code}
    checks["magic_solve_tripwire"] = verdict == {"pid": 1, "code": "panel_divergence"}
    return {"m": int(active.shape[0]), "block": 128, "seconds": seconds, "errs": errs,
            "bars": bars, "panel_checks": panel_checks, "panel_checks_per_factor": per_factor,
            "panel_spread": spread,
            "tripwire": verdict, "tripwire_seconds": time.perf_counter() - t0,
            "panel_divergence_bar": dl.PANEL_DIVERGENCE_BAR}


def cards(args: dict) -> dict:
    """mesh-cards, one rank a card under NCCL (``--cards N``, not a
    chip_smoke phase): the large-m config's magic solve row-sharded over
    the cards against one card's device solve (:func:`sharded_solve`:
    the bars, the panels' spread, the staged corruption), and gpc-mnist's
    device fit over the cards beside the unsharded device fit."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.parallel import distributed as pd
    from spark_gp_tpu_torch.utils.validation import accuracy

    rank, world = int(args["rank"]), int(args["world"])
    pd.initialize(f"file://{args['store']}", world, rank, backend=args.get("backend"),
                  timeout_s=CHILD_TIMEOUT_S)
    mesh = pd.global_expert_mesh(args.get("device"))
    checks, rec = {}, {"backend": mesh.backend, "world_size": world, "rank": rank,
                       "device": str(mesh.device)}
    rec["magic_solve"] = sharded_solve(mesh, checks, args["large_m"])
    cdata = cs.classifier_data()
    xm, ym, tr = cdata["xm"], cdata["ym"], cdata["tr_m"]
    te = np.setdiff1d(np.arange(xm.shape[0]), tr)
    make = lambda: cs.mnist_gpc(args.get("device")).setOptimizer("device")
    sharded, alone, seconds = _pair(make, xm[tr], ym[tr], mesh)
    ms = sharded.metrics
    rec["gpc_mnist"] = {"seconds": seconds, "theta": sharded.raw_predictor.theta.tolist(),
                        "theta_unsharded": alone.raw_predictor.theta.tolist(),
                        "accuracy": [float(accuracy(ym[te], m.predict(xm[te])))
                                     for m in (sharded, alone)],
                        "nfev": [ms["lbfgs_nfev"], alone.metrics["lbfgs_nfev"]],
                        "graph_nodes": [ms.get("device_opt.graph_nodes"),
                                        alone.metrics.get("device_opt.graph_nodes")],
                        "captures": ms.get("device_opt.captures")}
    checks["gpc_mnist_accuracy"] = min(rec["gpc_mnist"]["accuracy"]) > 0.84
    rec["checks"] = checks
    return rec


def child_main(argv) -> int:
    """``<phase> <args.json> <out.json>``: run one rank, write its record."""
    phase, args_path, out_path = argv
    with open(args_path, encoding="utf-8") as fh:
        args = json.load(fh)
    start = time.perf_counter()
    rec = {"nccl1": nccl1, "gloo2": gloo2, "cards": cards}[phase](args)
    rec["seconds"] = time.perf_counter() - start
    import torch.distributed as dist

    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(rec, fh)
    if phase != "gloo2":
        dist.destroy_process_group()
        return 0
    # the last step: rank 1 dies (exit 137), rank 0 names it at the deadline
    rec["dead_rank"] = dead_rank(int(args["rank"]))
    rec["checks"]["dead_rank_named"] = rec["dead_rank"]["missing"] == [1] and \
        rec["dead_rank"]["seconds"] < 8.0
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(rec, fh)
    # a group whose peer is gone is not torn down: exit without the teardown
    os._exit(0)


def _run_children(jobs_args, timeout_s: float, env=None, exits=None) -> list:
    """Start one child a ``(phase, rank, args)`` at once, each with
    ``timeout_s``; their records in order.  ``exits`` maps ``(phase,
    rank)`` to the exit code a child is to end with (default 0).  Raises
    naming the child that failed, timed out or wrote no record (its
    output's tail in the message), after every child has ended."""
    work = tempfile.mkdtemp(prefix="gp_mesh_")
    jobs = []
    for phase, rank, args in jobs_args:
        args = dict(args, rank=rank, store=os.path.join(work, f"{phase}.store"))
        args_path = os.path.join(work, f"{phase}-{rank}.args.json")
        with open(args_path, "w", encoding="utf-8") as fh:
            json.dump(args, fh)
        out_path = os.path.join(work, f"{phase}-{rank}.json")
        log = open(os.path.join(work, f"{phase}-{rank}.log"), "w+", encoding="utf-8")
        child_env = None if env is None else dict(os.environ, **env(rank))
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_gp_tpu_torch.dev.mesh_phases", phase, args_path,
             out_path], cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=child_env)
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
        if proc.returncode != (exits or {}).get((phase, rank), 0) \
                or not os.path.exists(out_path):
            log.seek(0)
            failures.append(f"{phase} rank {rank}: exit {proc.returncode}\n"
                            + log.read()[-3000:])
        log.close()
    if failures:
        raise AssertionError("mesh phases failed:\n" + "\n".join(failures))
    out = []
    for _, _, _, out_path, _ in jobs:
        with open(out_path, encoding="utf-8") as fh:
            out.append(json.load(fh))
    return out


def run_cards(world: int, large_m: dict, timeout_s: float = CHILD_TIMEOUT_S) -> dict:
    """mesh-cards (:func:`cards`) over ``world`` cards, one child a card:
    ``{"ranks": [records], "seconds": wall}``."""
    start = time.perf_counter()
    recs = _run_children([("cards", r, {"world": world, "large_m": large_m})
                          for r in range(world)], timeout_s,
                         env=lambda rank: {"LOCAL_RANK": str(rank)})
    return {"ranks": recs, "seconds": time.perf_counter() - start}


def run_mesh_phases(unsharded_thetas, large_m: dict, timeout_s: float = CHILD_TIMEOUT_S) -> dict:
    """Start the three ranks (mesh-nccl1's and mesh-gloo2's two) at once,
    each with ``timeout_s``; ``large_m`` is the large-m fit's ``theta`` and
    ``active`` (lists).  Return ``{"nccl1": record, "gloo2": [rank 0,
    rank 1], "seconds": wall, "ckpt_dir": the checkpoints' directory,
    "unsharded_thetas": as given}``
    (the caller resumes from mesh-gloo2's host checkpoint, then removes
    the directory).  Raises naming the child that failed, timed out or
    wrote no record (its output's tail in the message), after every child
    has ended; mesh-gloo2's rank 1 is to end with exit 137 (its dead-rank
    step)."""
    ckpt_dir = tempfile.mkdtemp(prefix="gp_mesh_ckpt_")
    args = {"unsharded_thetas": unsharded_thetas, "large_m": large_m, "ckpt_dir": ckpt_dir}
    start = time.perf_counter()
    try:
        nccl, *gloo = _run_children(
            [("nccl1", 0, args), ("gloo2", 0, args), ("gloo2", 1, args)], timeout_s,
            exits={("gloo2", 1): 137})
    except BaseException:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        raise
    return {"nccl1": nccl, "gloo2": gloo, "seconds": time.perf_counter() - start,
            "ckpt_dir": ckpt_dir, "unsharded_thetas": unsharded_thetas}


def elastic_resume(out: dict) -> dict:
    """The parent's step after the children: a plain one-process fit of
    airfoil fold 0 resumes from the two-rank host checkpoint that
    mesh-gloo2's preemption left (an elastic resume, counted once): it
    replays the evaluations the two ranks logged and runs the rest of the
    fit live on the whole fold; removes the checkpoints' directory.
    Returns its record: beside the counts, its RMSE and final NLL (the
    bars compare them with the two-rank fit's) and theta's largest
    relative distance from the two-rank fit's and from the uninterrupted
    one-process fold's.  On the card a live continuation in one process
    sums the experts' float32 values in another order than two ranks do,
    which moves L-BFGS along the flat directions of the airfoil surface:
    theta is recorded, not held to the two-rank fit's."""
    import chip_smoke as cs
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.ops import spd_linalg as spd

    try:
        x, y, folds = airfoil_data()
        train, test = folds[0]
        pre = out["gloo2"][0]["coord"]["preemption"]
        before = telemetry.snapshot()["counters"].get("coord.elastic_resumes", 0.0)
        k1_before = spd.spd_inv_logdet.launches
        t0 = time.perf_counter()
        model = cs.airfoil_gp(100).setCheckpointDir(pre["preempted_copy"]).fit(x[train],
                                                                                y[train])
        seconds = time.perf_counter() - t0
        theta, ref = model.raw_predictor.theta, np.asarray(pre["theta"])
        return {"seconds": seconds,
                "elastic_resumes": telemetry.snapshot()["counters"].get(
                    "coord.elastic_resumes", 0.0) - before,
                "resumed_from_iteration": model.metrics.get("resumed_from_iteration", 0),
                "nfev": int(model.metrics["lbfgs_nfev"]),
                "k1": spd.spd_inv_logdet.launches - k1_before,
                "k1_rule": int(model.metrics["lbfgs_nfev"]) + _probe_k1(model),
                "max_rel_theta_diff": _rel_diff(theta, ref),
                "max_rel_theta_diff_unsharded": _rel_diff(theta, out["unsharded_thetas"][0]),
                "rmse": _fold_rmse(model, x, y, test),
                "final_nll": model.metrics["final_nll"],
                "two_rank_rmse": pre["rmse"], "two_rank_final_nll": pre["final_nll"],
                "stored_process_count": pre["elastic_process_count"]}
    finally:
        shutil.rmtree(out["ckpt_dir"], ignore_errors=True)


def main(argv) -> int:
    """By hand: build the kernels, fit the large-m config and (for the
    mesh phases) the unsharded airfoil folds, run the mesh phases, or with
    ``--cards N`` mesh-cards over N cards (a call with N chips), and print
    their records."""
    import torch

    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_gp_tpu_torch.ops import cuda_lib

    cuda_lib.build_all(["spd_inv_logdet", "streamed_matvec", "slq_quadrature", "lane_gram"])
    raw = cs.large_m_gp().fit(*cs.large_m_data()).raw_predictor
    large_m = {"theta": raw.theta.tolist(), "active": raw.active.tolist()}
    if argv[:1] == ["--cards"]:
        print(json.dumps(run_cards(int(argv[1]), large_m)))
        return 0
    x, y, folds = airfoil_data()
    cv = cs.regression_cv(cs.airfoil_gp(100), x, y, folds)
    out = run_mesh_phases([f["theta"] for f in cv["per_fold"]], large_m)
    out["elastic_resume"] = elastic_resume(out)
    out["unsharded_rmse"] = cv["rmse"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:]) if len(sys.argv) == 4 else main(sys.argv[1:]))
