#!/usr/bin/env python3
"""What breaks the device optimizer's CUDA-graph capture while other CUDA
graphs die, on the card.

    python3 spark_gp_tpu_torch/dev/capture_finalizer_ab.py

A regression device fit (``likelihood.fit_gpr_device``, a (14, 100, 5)
float32 stack) captures its step once.  Two hazards, each with and
without its guard:

* ``collection``: six replayed CUDA graphs holding pool blocks become a
  dead reference cycle inside the capture, and the cyclic collector runs
  on the next allocations, on the capturing thread -- with the collector
  held off for the capture (``ops/cuda_lib.collector_held``, what
  ``DeviceLoop.capture`` does) and without;
* ``other_thread``: another thread frees captured graphs while the fit
  captures -- in the ``thread_local`` capture mode (what
  ``DeviceLoop.capture`` does) and in the default ``global`` one.

One JSON line per case (``ok``: the fit captured and ran), then the
card's name and power limit.  Needs one CUDA card; run from the repo
root.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("capture_finalizer_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from spark_gp_tpu_torch import Const, EyeKernel, RBFKernel
    from spark_gp_tpu_torch.models import likelihood as lk
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.optimize import lbfgs_device as ldv
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1400, 5))
    data = group_for_experts(x, np.sin(x.sum(1)), 100, dtype=torch.float32, device="cuda")
    kernel = 1.0 * RBFKernel(1.0) + Const(1e-4) * EyeKernel()

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                               device="cuda")

    lower, upper = (dev(b) for b in kernel.bounds())

    def captured_graph():
        buf = torch.ones(1 << 20, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = buf * 2  # a block of the graph's private pool
        graph.replay()
        return graph, buf, out

    def fit():
        loop: dict = {}
        try:
            out = lk.fit_gpr_device(kernel, True, dev(kernel.init_theta()), lower, upper, data,
                                    50, 1e-6, loop_metrics=loop)
            torch.cuda.synchronize()
            return {"ok": True, "n_fev": int(out[3]), "captures": loop["captures"]}
        except cuda_lib.GraphCaptureError as exc:
            return {"ok": False, "error": str(exc).splitlines()[0][:160]}

    class Holder:
        pass

    pending: list = []
    real_step = ldv.lbfgs_step

    def step_that_kills(*args, **kwargs):
        # the pending graphs become a dead cycle mid-capture, and the
        # collector runs on the next allocations
        if torch.cuda.is_current_stream_capturing() and pending:
            for item in pending:
                holder = Holder()
                holder.me, holder.item = holder, item
            pending.clear()
            gc.set_threshold(1, 1, 1)
        return real_step(*args, **kwargs)

    threshold = gc.get_threshold()
    held = cuda_lib.collector_held
    ldv.lbfgs_step = step_that_kills
    for guard, ctx in (("collector_held", held), ("collector_free", contextlib.nullcontext)):
        cuda_lib.collector_held = ctx
        pending.extend(captured_graph() for _ in range(6))
        torch.cuda.synchronize()
        try:
            row = fit()
        finally:
            gc.set_threshold(*threshold)
            gc.collect()
            torch.cuda.synchronize()
        print(json.dumps({"case": "collection", "guard": guard, **row}), flush=True)
    ldv.lbfgs_step = real_step
    cuda_lib.collector_held = held

    real_graph = torch.cuda.graph
    for mode in ("thread_local", "global"):
        def graph_in_mode(graph, **kw):
            kw["capture_error_mode"] = mode
            return real_graph(graph, **kw)

        graphs = [captured_graph() for _ in range(300)]
        torch.cuda.synchronize()
        stop = threading.Event()

        def free_them():
            while graphs and not stop.is_set():
                graphs.pop()
                time.sleep(0.0005)

        torch.cuda.graph = graph_in_mode
        freer = threading.Thread(target=free_them)
        freer.start()
        try:
            row = fit()
        finally:
            stop.set()
            freer.join()
            torch.cuda.graph = real_graph
        print(json.dumps({"case": "other_thread", "capture_mode": mode,
                          "graphs_freed": 300 - len(graphs), **row}), flush=True)
        del graphs
        gc.collect()
        torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
