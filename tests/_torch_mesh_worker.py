"""The ranks of a gloo process group for the port's mesh tests.

:class:`MeshPool` starts ``world`` processes once (a test module's
fixture), each joining one gloo group through a ``FileStore`` file under
the test's temporary directory (no TCP port: several test files run at
once).  :meth:`MeshPool.run` sends every rank the same scenario, which
each runs on its own block, and returns the ranks' results as numpy.
Every wait has a timeout: the group's own (``init_process_group``), and
the pool's on each reply.  The ranks import the port and never JAX.

The ranks join through ``parallel/distributed.initialize``, which keeps
the group's store for the coordination plane (``parallel/coord.py``).
Scenarios are the functions in :data:`SCENARIOS`; each takes the rank's
mesh first.  :func:`estimator` builds the port's estimator from a plain
spec, so a test builds the JAX one from the same spec."""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback

import numpy as np

#: seconds a rank waits on the group, and the pool on one reply
TIMEOUT_S = 120.0


def estimator(spec: dict, m=None):
    """The estimator of ``spec`` in the package ``m`` (the port when None):
    ``family`` (``gpr``, ``gpc``, ``gpc_mc``, ``poisson``, ``ep``), ``p``
    (the ARD width; 0 for an isotropic RBF), ``s``, ``m_active``,
    ``sigma2``, ``maxiter``, ``seed``, ``provider`` (``random``,
    ``kmeans``, ``greedy``), ``optimizer``, ``tol``, ``objective``."""
    if m is None:
        import spark_gp_tpu_torch as m
    cls = {"gpr": m.GaussianProcessRegression, "gpc": m.GaussianProcessClassifier,
           "gpc_mc": m.GaussianProcessMulticlassClassifier,
           "poisson": m.GaussianProcessPoissonRegression,
           "ep": m.GaussianProcessEPClassifier}[spec["family"]]
    kw = {} if m.__name__ == "spark_gp_tpu" else {"device": "cpu"}
    p = int(spec.get("p", 0))

    def kernel():
        if p:
            return 1.0 * m.ARDRBFKernel(p) + m.Const(1.0) * m.EyeKernel()
        return m.RBFKernel(float(spec.get("length", 1.0)))

    gp = (cls(**kw).setKernel(kernel).setDatasetSizeForExpert(int(spec["s"]))
          .setActiveSetSize(int(spec.get("m_active", 20))).setSigma2(float(spec.get("sigma2", 1e-3)))
          .setMaxIter(int(spec.get("maxiter", 10))).setSeed(int(spec.get("seed", 7)))
          .setTol(float(spec.get("tol", 1e-6))))
    provider = spec.get("provider", "random")
    if provider == "kmeans":
        gp = gp.setActiveSetProvider(m.KMeansActiveSetProvider())
    elif provider == "greedy":
        gp = gp.setActiveSetProvider(m.GreedilyOptimizingActiveSetProvider())
    if spec.get("optimizer"):
        gp = gp.setOptimizer(spec["optimizer"])
    if spec.get("objective"):
        gp = gp.setObjective(spec["objective"])
    return gp


def _stack(x, y, s, mesh):
    """This rank's block of the stack of all rows ``(x, y)``."""
    import torch

    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.parallel.mesh import shard_experts

    data = group_for_experts(x, y, s, dtype=torch.float64, device="cpu")
    return data if mesh is None else shard_experts(data, mesh)


def _kernel_of(spec):
    return estimator(spec)._get_kernel()


# -- scenarios (each rank runs one with its mesh) --------------------------------


def objective(mesh, spec, x, y, theta, objective="marginal", lane="exact", weights=None):
    """The sharded regression objective's ``(value, grad)`` at ``theta``."""
    import torch

    from spark_gp_tpu_torch.models.likelihood import make_sharded_value_and_grad
    from spark_gp_tpu_torch.ops.iterative import solver_lane_scope
    from spark_gp_tpu_torch.parallel.mesh import sharded_weights_operand

    data = _stack(x, y, spec["s"], mesh)
    w = sharded_weights_operand(None if weights is None else torch.as_tensor(weights), mesh)
    with solver_lane_scope(lane):
        vag = make_sharded_value_and_grad(_kernel_of(spec), data, mesh, objective, weights=w)
        value, grad = vag(theta)
    return np.asarray([value]), grad


def kmn(mesh, spec, x, y, theta, active):
    """The sharded ``(U1, u2)``."""
    import torch

    from spark_gp_tpu_torch.models import ppa

    data = _stack(x, y, spec["s"], mesh)
    u1, u2 = ppa.make_sharded_kmn_stats(_kernel_of(spec), mesh)(
        torch.as_tensor(theta), torch.as_tensor(active), data)
    return u1.numpy(), u2.numpy()


def latent_objective(mesh, spec, x, y, theta):
    """The sharded Laplace-family (or EP) objective's ``(value, grad)`` at
    ``theta`` from zero latents."""
    import torch

    from spark_gp_tpu_torch.models import ep, laplace, laplace_generic, laplace_mc

    data = _stack(x, y, spec["s"], mesh)
    kernel, fam, tol = _kernel_of(spec), spec["family"], float(spec.get("tol", 1e-6))
    if fam == "gpc":
        obj = laplace.make_sharded_laplace_objective(kernel, data, tol, mesh)
        value, grad, _ = obj(theta, torch.zeros_like(data.y))
    elif fam == "gpc_mc":
        c = int(spec["classes"])
        y1h = torch.nn.functional.one_hot(data.y.long(), c).double() * data.mask[..., None]
        obj = laplace_mc.make_sharded_mc_objective(kernel, data.x, y1h, data.mask, tol, mesh)
        value, grad, _ = obj(theta, torch.zeros_like(y1h))
    elif fam == "poisson":
        obj = laplace_generic.make_sharded_generic_objective(
            laplace_generic.PoissonLikelihood(), kernel, data.x, data.y, data.mask, tol, mesh)
        value, grad, _ = obj(theta, torch.zeros_like(data.y))
    else:
        obj = ep.make_sharded_ep_objective(kernel, data, tol, mesh)
        value, grad, _ = obj(theta, (torch.zeros_like(data.y), torch.zeros_like(data.y)))
    return np.asarray([value]), grad


class _Env:
    """``env`` set around a block, the environment restored after."""

    def __init__(self, env):
        self.env = env or {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def fit(mesh, spec, x, y, xt, mode="mesh_fit", active=None, rows=None, env=None):
    """A fit over the mesh and its ``(theta, predictions at xt, active set,
    [nfev, num_experts])``; the environment ``env`` is set around it.
    ``mode``: ``mesh_fit`` (``setMesh(mesh).fit`` on every rank's copy of
    the rows), ``distributed`` (``fit_distributed`` of this rank's block of
    the stack of all rows), ``rows`` (``fit_distributed`` of
    ``distribute_global_experts`` over this rank's slice ``rows[rank]`` of
    the rows)."""
    gp = estimator(spec)
    if mesh is not None:
        gp = gp.setMesh(mesh)
    with _Env(env):
        return _fit_record(gp, mesh, spec, x, y, xt, mode, active, rows)


def _fit_record(gp, mesh, spec, x, y, xt, mode, active, rows):
    from spark_gp_tpu_torch.parallel.distributed import distribute_global_experts

    if mode == "mesh_fit":
        model = gp.fit(x, y)
    elif mode == "distributed":
        model = gp.fit_distributed(_stack(x, y, spec["s"], mesh), active_set=active)
    else:
        lo, hi = rows[0 if mesh is None else mesh.rank]
        data = distribute_global_experts(x[lo:hi], y[lo:hi], spec["s"], mesh, device="cpu")
        model = gp.fit_distributed(data, active_set=active)
    raw = model.raw_predictor
    pred = raw.predict_mean(xt).cpu().numpy()
    return (np.asarray(raw.theta), np.asarray(pred), np.asarray(raw.active),
            np.asarray([model.metrics["lbfgs_nfev"], model.metrics["num_experts"]]))


def poe(mesh, spec, x, y, xt, theta, mode):
    """The sharded PoE predictor's ``(mean, var)``."""
    from spark_gp_tpu_torch.models.poe import make_poe_predictor

    pred = make_poe_predictor(_kernel_of(spec), theta, x, y, spec["s"], mode=mode,
                              device="cpu", mesh=mesh)
    return pred.predict_with_var(xt)


def distribute(mesh, x_parts, y_parts, s):
    """``distribute_global_experts`` of this rank's rows: its block."""
    from spark_gp_tpu_torch.parallel.distributed import distribute_global_experts

    r = mesh.rank
    data = distribute_global_experts(x_parts[r], y_parts[r], s, mesh, device="cpu")
    return data.x.numpy(), data.y.numpy(), data.mask.numpy()


def sample(mesh, x_parts, y_parts, s, m, seed, provider="random", spec=None, theta=None):
    """The active set a ``from_stack`` provider draws off the distributed
    stack."""
    from spark_gp_tpu_torch.parallel.distributed import distribute_global_experts

    r = mesh.rank
    data = distribute_global_experts(x_parts[r], y_parts[r], s, mesh, device="cpu")
    gp = estimator(spec or {"family": "gpr", "s": s, "provider": provider})
    kernel = gp._get_kernel()
    th = kernel.init_theta() if theta is None else theta
    return gp._active_set_provider.from_stack(m, data, kernel, th, seed, mesh)


def default_device(mesh):
    """The device of a mesh over this group that names none: the card,
    or the error of a host without one."""
    from spark_gp_tpu_torch.parallel.mesh import expert_mesh

    try:
        return str(expert_mesh().device)
    except RuntimeError as exc:
        return f"raised: {exc}"


def raised(fn):
    """``fn()``'s result, or ``"raised <type>: <message>"`` for its error."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 -- the test reads the rank's verdict
        return f"raised {type(exc).__name__}: {exc}"


def dist_chol(mesh, a, rhs, block):
    """The sharded factor of ``a`` gathered whole, and its solves of each
    right-hand side of ``rhs`` (or the error: a granularity refused)."""
    import torch

    from spark_gp_tpu_torch.ops import dist_linalg as dl

    def run():
        chol = dl.sharded_cholesky(mesh, torch.as_tensor(a), block)
        full = torch.cat(mesh.all_gather(chol)).numpy()
        return [full] + [dl.sharded_chol_solve(mesh, chol, torch.as_tensor(r), block).numpy()
                         for r in rhs]

    return raised(run)


def tripwire(mesh, a, block, corrupt):
    """The panel tripwire at ``GP_INTEGRITY_PANEL_SAMPLE=1``: the clean
    factor, the panel checks it counted and their cross-rank spread, the
    verdict on a staged
    ``corrupt_device(corrupt)`` (``(pid, code, failure class)``), and the
    factor the same corruption gives silently at ``GP_INTEGRITY=0``."""
    import torch

    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.ops import dist_linalg as dl
    from spark_gp_tpu_torch.resilience import chaos, integrity
    from spark_gp_tpu_torch.resilience.fallback import classify_failure

    a = torch.as_tensor(a)
    saved = {k: os.environ.get(k) for k in ("GP_INTEGRITY", "GP_INTEGRITY_PANEL_SAMPLE")}
    os.environ["GP_INTEGRITY_PANEL_SAMPLE"] = "1.0"
    try:
        before = telemetry.snapshot()["counters"].get("integrity.panel_checks", 0.0)
        clean = torch.cat(mesh.all_gather(dl.sharded_cholesky(mesh, a, block))).numpy()
        snap = telemetry.snapshot()
        checks = snap["counters"].get("integrity.panel_checks", 0.0) - before
        spread = snap["gauges"]["integrity.panel_spread"]
        verdict = None
        try:
            with chaos.corrupt_device(corrupt):
                dl.sharded_cholesky(mesh, a, block)
        except integrity.PanelMismatchError as exc:
            verdict = (exc.pid, exc.code, classify_failure(exc))
        os.environ["GP_INTEGRITY"] = "0"
        with chaos.corrupt_device(corrupt):
            silent = torch.cat(mesh.all_gather(dl.sharded_cholesky(mesh, a, block))).numpy()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return clean, checks, spread, verdict, silent


def magic(mesh, length, noise, active, u1, u2, block, with_variance=True):
    """``ppa.sharded_magic_solve`` of an RBF(``length``) + ``noise`` Eye
    kernel at its initial theta, and the jitter warnings it logged."""
    import logging

    from spark_gp_tpu_torch import Const, EyeKernel, RBFKernel
    from spark_gp_tpu_torch.models import ppa

    kernel = RBFKernel(length) + Const(noise) * EyeKernel()
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logger = logging.getLogger("spark_gp_tpu_torch")
    logger.addHandler(handler)
    try:
        mv, mm = ppa.sharded_magic_solve(kernel, kernel.init_theta(), active, u1, u2, mesh,
                                         block=block, with_variance=with_variance)
    finally:
        logger.removeHandler(handler)
    return mv, mm, records


def elbo(mesh, spec, x, y, theta, active, sigma2):
    """The sharded ELBO's ``(value, grad)`` at ``theta``."""
    from spark_gp_tpu_torch.models.likelihood import make_sharded_value_and_grad

    data = _stack(x, y, spec["s"], mesh)
    value, grad = make_sharded_value_and_grad(_kernel_of(spec), data, mesh, "elbo",
                                              extra=(active, sigma2))(theta)
    return np.asarray([value]), grad


def select(mesh, x, y, s, mode, seed):
    """Fit-time selection's report over the mesh: ``(drop, weights)``."""
    from spark_gp_tpu_torch.models.aggregation import select_experts
    from spark_gp_tpu_torch.parallel.experts import num_experts_for

    report = select_experts(_stack(x, y, s, mesh), mode=mode, seed=seed, mesh=mesh,
                            num_experts=num_experts_for(x.shape[0], s))
    return report.drop, report.weights


def row_sharded_fit(mesh, spec, x, y, xt, min_m):
    """A ``setMesh`` fit with the device solve's threshold lowered to
    ``min_m``: its record (:func:`fit`) and the sharded magic solves it ran."""
    from spark_gp_tpu_torch.models import ppa

    solve, threshold = ppa.sharded_magic_solve, ppa._DEVICE_SOLVE_MIN_M
    calls = []

    def counted(*args, **kw):
        calls.append(args[2].shape[0])
        return solve(*args, **kw)

    ppa.sharded_magic_solve, ppa._DEVICE_SOLVE_MIN_M = counted, int(min_m)
    try:
        return fit(mesh, spec, x, y, xt) + (np.asarray(calls),)
    finally:
        ppa.sharded_magic_solve, ppa._DEVICE_SOLVE_MIN_M = solve, threshold


#: the process group's collectives, counted by :func:`store_fit`
_COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "reduce", "gather", "scatter",
                "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
                "all_to_all", "all_gather_object", "broadcast_object_list", "barrier",
                "monitored_barrier", "send", "recv")


def store_fit(mesh, spec, x, y, xt, env=None):
    """``fit_distributed`` of this rank's block under ``GP_DCN_MODE=1``
    (plus ``env``): the record of :func:`fit`, the process-group
    collectives it made (every one counted), the store rounds of its
    context by name, and the rungs of its spot checks."""
    import torch.distributed as dist

    from spark_gp_tpu_torch.parallel import coord

    calls = []
    saved = {n: getattr(dist, n) for n in _COLLECTIVES if hasattr(dist, n)}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    for name, fn in saved.items():
        setattr(dist, name, counting(name, fn))
    try:
        with _Env(dict({"GP_DCN_MODE": "1"}, **(env or {}))):
            ctx = coord.dcn_context()
            gathers, audits = dict(ctx.gathers), len(ctx.audits)
            rec = fit(mesh, spec, x, y, xt, mode="distributed")
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    rounds = {k: v - gathers.get(k, 0) for k, v in ctx.gathers.items()}
    return rec + (len(calls), rounds, list(ctx.audits[audits:]))


def ladder_fit(mesh, spec, x, y, xt):
    """``fit_distributed`` of this rank's block over the process group
    with a compile failure staged on its first host fit attempt, the
    store mode switched off: ``(theta, the degradations' target rungs,
    the store rounds of the process's store context by name)``."""
    from spark_gp_tpu_torch.parallel import coord
    from spark_gp_tpu_torch.resilience import chaos

    gp = estimator(spec).setMesh(mesh)
    with _Env({"GP_DCN_MODE": "0"}), chaos.failing_compile(1, op="fit.host"):
        model = gp.fit_distributed(_stack(x, y, spec["s"], mesh))
    return (np.asarray(model.raw_predictor.theta), [d["to"] for d in model.degradations],
            dict(coord.store_context().gathers))


def skipped_barrier(mesh, barrier_name, skip, timeout_s):
    """Every rank but ``skip`` meets at the store barrier ``barrier_name`` under
    ``GP_COORD_TIMEOUT_S=timeout_s``: ``(missing, seconds)`` of the
    timeout each raised (None on the skipping rank)."""
    import time

    from spark_gp_tpu_torch.parallel import coord

    if mesh.rank == skip:
        return None
    t0 = time.perf_counter()
    with _Env({"GP_COORD_TIMEOUT_S": str(timeout_s)}):
        try:
            coord.barrier(barrier_name)
        except coord.CoordinationTimeoutError as exc:
            return list(exc.missing), time.perf_counter() - t0
    return "no timeout", time.perf_counter() - t0


def preempted_checkpoint(mesh, spec, x, y, directory, preempt_rank, optimizer="host"):
    """A ``setMesh`` fit with ``setCheckpointDir(directory)`` while rank
    ``preempt_rank`` stages a preemption, then the resume: ``(what the
    first fit raised, coord.checkpoints it counted, the checkpoint's
    iteration, the uninterrupted fit's theta, the resumed fit's theta,
    resumed_from_iteration)``."""
    import json

    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.parallel import coord
    from spark_gp_tpu_torch.resilience import chaos

    def gp(ck=None):
        g = estimator(spec).setMesh(mesh).setOptimizer(optimizer)
        if ck is not None:
            g = g.setCheckpointDir(ck).setCheckpointInterval(2)
        return g

    ref = gp().fit(x, y).raw_predictor.theta
    before = telemetry.snapshot()["counters"].get("coord.checkpoints", 0.0)
    raised = None
    if mesh.rank == preempt_rank:
        chaos.stage_preemption(True)
    try:
        gp(directory).fit(x, y)
    except coord.PreemptedError as exc:
        raised = type(exc).__name__
    finally:
        chaos.stage_preemption(False)
        coord.clear_preemption_for_testing()
    saves = telemetry.snapshot()["counters"].get("coord.checkpoints", 0.0) - before
    iteration = None
    path = os.path.join(directory, f"lbfgs_state_{type(gp()).__name__}.json")
    if os.path.exists(path):
        with open(path) as fh:
            iteration = json.load(fh)["iteration"]
    resumed = gp(directory).fit(x, y)
    return (raised, saves, iteration, np.asarray(ref), np.asarray(resumed.raw_predictor.theta),
            resumed.metrics.get("resumed_from_iteration", 0))


SCENARIOS = {f.__name__: f for f in (objective, kmn, latent_objective, fit, poe, distribute,
                                     sample, default_device, dist_chol, tripwire, magic, elbo,
                                     select, row_sharded_fit, store_fit, ladder_fit,
                                     skipped_barrier, preempted_checkpoint)}


# -- the ranks -----------------------------------------------------------------------


def _serve(rank: int, world: int, init_file: str, conn) -> None:
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from spark_gp_tpu_torch.parallel import distributed
    from spark_gp_tpu_torch.parallel.mesh import expert_mesh

    distributed.initialize(f"file://{init_file}", world, rank, backend="gloo",
                           timeout_s=TIMEOUT_S)
    mesh = expert_mesh(device="cpu")
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                conn.send(("ok", SCENARIOS[name](mesh, **kwargs)))
            except Exception:  # noqa: BLE001 -- the test reports the rank's traceback
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class MeshPool:
    """``world`` ranks of one gloo group, started once."""

    def __init__(self, world: int, tmpdir) -> None:
        ctx = mp.get_context("spawn")
        init_file = os.path.join(str(tmpdir), "gloo_store")
        self.world = world
        self.conns, self.procs = [], []
        self._pending = None
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(rank, world, init_file, child), daemon=True)
            proc.start()
            self.conns.append(parent)
            self.procs.append(proc)

    def submit(self, name: str, **kwargs):
        """Send every rank scenario ``name`` and return at once, so the ranks
        work while the caller computes its own side; the function returned
        waits for the ranks' results, in rank order, and raises with a
        rank's traceback, or after :data:`TIMEOUT_S` without a reply."""
        self._drain()
        for conn in self.conns:
            conn.send((name, kwargs))
        self._pending = name
        return self._collect

    def run(self, name: str, **kwargs) -> list:
        """Every rank's result of scenario ``name`` (:meth:`submit`, then
        wait)."""
        return self.submit(name, **kwargs)()

    def _replies(self) -> list:
        name, self._pending = self._pending, None
        out = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(TIMEOUT_S):
                raise TimeoutError(f"rank {rank} gave no reply to {name!r} in {TIMEOUT_S} s")
            out.append(conn.recv())
        return [name] + out

    def _collect(self) -> list:
        name, *replies = self._replies()
        for rank, (status, value) in enumerate(replies):
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed {name!r}:\n{value}")
        return [value for _, value in replies]

    def _drain(self) -> None:
        """Read the replies to a scenario whose test failed before it waited
        for them, so the next scenario's replies are its own."""
        if self._pending is not None:
            self._replies()

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
