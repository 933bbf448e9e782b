"""Compare versions of a kernel on the card: K2's forward kernel, K2-VJP, or K1.

    python3 spark_gp_tpu_torch/csrc/dev/variants.py SPEC.json [--kernel K] [--out variants.json]

SPEC maps a variant name to ``[source, edits]``: ``source`` is a path
relative to the repository root whose C entry points are those of
``spark_gp_tpu_torch/csrc/<K>.cu``; ``edits`` is a list of
``[find, replace]`` pairs, each of which must match exactly once.

Every variant is built with the package's nvcc flags (one nvcc each, all
started together) and run through the package's wrapper with its library in place of the
package's.  ``--kernel streamed_matvec`` (the default; ``ops/streamed_matvec.py``):
- checked by ``chip_smoke.check_streamed_matvec`` (every shape, width,
  tile transform and bar of the chip smoke run; a variant that drops work
  on purpose fails it and is timed all the same);
- measured for the bias of K: the mean of (out - ref) / ref with V = 1
  (RBF, sigma 0.6 and 1.0), which a random V averages away;
- timed by ``chip_smoke.time_ms`` with the RBF map at sigma = 1 on the
  (9, 4065, 9) stack at n = 9, 1, 8, 16 (the variants in order, then in
  reverse).
``--kernel streamed_matvec_vjp`` (the same wrapper and library):
- checked by ``chip_smoke.check_streamed_matvec`` as above (the VJP's
  errors are reported);
- timed with the RBF map at sigma = 1 on the (9, 4065, 9) stack at n = 8
  and n = 1: device time by ``chip_smoke.time_device_ms`` (the variants
  in order, then in reverse; the eager loop at n = 1 reads the host as
  often as the kernel) and the eager loop's time by
  ``chip_smoke.time_ms``.
``--kernel spd_inv_logdet`` (``ops/spd_linalg.py``):
- checked by ``chip_smoke.check_spd_inv_logdet`` on the exact lane's gram
  stacks (``chip_smoke.exact_lane_stacks``) and all its random shapes;
- timed on the airfoil fold's (14, 97) and the protein (366, 100) stacks,
  on random SPD batches at (2, 256) and (1, 512), and on the airfoil
  fold's stack at expert 450 (3, 451) and the protein split's at expert
  400 (91, 403): device time by
  ``chip_smoke.time_device_ms`` (the variants in order, then in reverse)
  and the eager loop's wall time per call by ``chip_smoke.time_ms``.
The ptxas registers and spill stores of each kernel instance, the card's
name and power limit and all numbers go to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from spark_gp_tpu_torch.ops import cuda_lib  # noqa: E402
from spark_gp_tpu_torch.ops import spd_linalg as spd  # noqa: E402
from spark_gp_tpu_torch.ops import streamed_matvec as sm  # noqa: E402

def sources(spec: dict) -> dict:
    out = {}
    for name, (path, edits) in spec.items():
        text = (REPO / path).read_text()
        for find, replace in edits:
            if text.count(find) != 1:
                raise SystemExit(f"{name}: {find!r} matches {text.count(find)} times")
            text = text.replace(find, replace)
        out[name] = text
    return out


def build(texts: dict, build_dir: Path, kernel: str) -> dict:
    """{name: (library, {instance: [registers, spill bytes]})}"""
    module, pattern, label, _ = KERNELS[kernel]
    procs = {}
    for name, text in texts.items():
        src = build_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(build_dir / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log[-4000:]}")
        libs[name] = (module.bind(ctypes.CDLL(str(build_dir / f"lib{name}.so"))),
                      chip_smoke.ptxas_usage(log, pattern, label))
    return libs


def _use_k2(libs: dict, name: str) -> None:
    """Run the K2 wrapper on variant ``name``'s library."""
    sm._library = lambda lib=libs[name][0]: lib


def _k2_checked(libs: dict, key: str):
    """The (9, 4065, 9) stack and its generator, and every variant through
    ``chip_smoke.check_streamed_matvec``: the largest error ``key`` over
    its checks, or the check that failed."""
    gen = np.random.default_rng(0)
    x = torch.as_tensor(gen.normal(size=(9, 4065, 9)) / 3.0, dtype=torch.float32, device="cuda")
    result = {"max_rel_err": {}, "failed": {}}
    for name in libs:
        _use_k2(libs, name)
        try:
            errs = chip_smoke.check_streamed_matvec(torch, sm, x)
            result["max_rel_err"][name] = max(e[key] for e in errs.values())
        except AssertionError as err:
            result["max_rel_err"][name] = None
            result["failed"][name] = str(err)
    return gen, x, result


def _measure(libs: dict) -> dict:
    """Checks, bias and times of every K2 variant, each run through the
    wrapper with its library swapped in."""
    gen, x, result = _k2_checked(libs, "matvec_rel")
    result.update(bias={}, ms={})
    ones = torch.ones((9, 4065, 1), dtype=torch.float32, device="cuda")
    for sigma in (0.6, 1.0):
        par = torch.tensor([sigma], dtype=torch.float32, device="cuda")
        ref = sm.streamed_matvec_plain(x.double(), ones.double(), "rbf", par.double())
        for name in libs:
            _use_k2(libs, name)
            rel = (sm.streamed_matvec(x, ones, "rbf", par).double() - ref) / ref
            result["bias"].setdefault(f"sigma{sigma}", {})[name] = {
                "mean_rel": rel.mean().item(), "max_rel": rel.abs().max().item()}

    par = torch.ones(1, dtype=torch.float32, device="cuda")
    order = list(libs) + list(libs)[::-1]
    for n in (9, 1, 8, 16):
        v = torch.as_tensor(gen.normal(size=(9, 4065, n)), dtype=torch.float32, device="cuda")
        for name in order:
            _use_k2(libs, name)
            result["ms"].setdefault(f"n{n}", {}).setdefault(name, []).append(
                chip_smoke.time_ms(lambda: sm.streamed_matvec(x, v, "rbf", par)))
    return result


def _measure_vjp(libs: dict) -> dict:
    """Checks and times of every K2-VJP variant, each run through the
    wrapper with its library swapped in."""
    gen, x, result = _k2_checked(libs, "vjp_rel")
    result.update(ms={}, wall_ms={})
    par = torch.ones(1, dtype=torch.float32, device="cuda")
    order = list(libs) + list(libs)[::-1]
    for n in (8, 1):
        v, w = (torch.as_tensor(gen.normal(size=(9, 4065, n)), dtype=torch.float32,
                                device="cuda") for _ in range(2))

        def call():
            return sm.streamed_matvec_vjp(x, w, v, "rbf", par)

        for name in order:
            _use_k2(libs, name)
            result["ms"].setdefault(f"n{n}", {}).setdefault(name, []).append(
                chip_smoke.time_device_ms(call))
        for name in libs:
            _use_k2(libs, name)
            result["wall_ms"].setdefault(f"n{n}", {})[name] = chip_smoke.time_ms(call)
    return result


def _measure_k1(libs: dict) -> dict:
    """Checks and times of every K1 variant, each run through the wrapper
    with its library swapped in."""
    def use(name):
        spd._library = lambda lib=libs[name][0]: lib

    stacks = chip_smoke.exact_lane_stacks(torch, chip_smoke.main_path_data())
    result = {"max_abs_err": {}, "failed": {}, "ms": {}, "wall_ms": {}}
    for name in libs:
        use(name)
        try:
            errs = chip_smoke.check_spd_inv_logdet(torch, spd, stacks)
            result["max_abs_err"][name] = {"all": max(errs.values()),
                                           **{k: errs[k] for k in stacks}}
        except AssertionError as err:
            result["max_abs_err"][name] = None
            result["failed"][name] = str(err)
    inputs = {"14x97": stacks["airfoil_fold"], "366x100": stacks["protein"],
              **{f"{b}x{n}": torch.as_tensor(chip_smoke.spd_batch(b, n, seed=n), device="cuda")
                 for b, n in ((2, 256), (1, 512))},
              "3x451": stacks["airfoil_expert450"], "91x403": stacks["protein_expert400"]}
    order = list(libs) + list(libs)[::-1]
    for label, k in inputs.items():
        for name in order:
            use(name)
            result["ms"].setdefault(label, {}).setdefault(name, []).append(
                chip_smoke.time_device_ms(lambda k=k: spd.spd_inv_logdet(k)))
        for name in libs:
            use(name)
            result["wall_ms"].setdefault(label, {})[name] = chip_smoke.time_ms(
                lambda k=k: spd.spd_inv_logdet(k))
    return result


#: per kernel: its wrapper module, a pattern naming each kernel instance in
#: ptxas's "Compiling entry function" lines, and what measures a variant
KERNELS = {
    "streamed_matvec": (sm, r"streamed_matvec_kernelILi(\d)ELi(\d+)EE", "F{0}/NB{1}", _measure),
    "streamed_matvec_vjp": (sm, *chip_smoke.VJP_PTXAS, _measure_vjp),
    "spd_inv_logdet": (spd, r"(spd_inv_logdet\w*?_kernel)", "{0}", _measure_k1),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("spec")
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="streamed_matvec")
    parser.add_argument("--out", default="variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("variants.py: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    texts = sources(json.loads(Path(args.spec).read_text()))
    start = time.perf_counter()
    module = KERNELS[args.kernel][0]
    package_library = module._library
    try:
        with tempfile.TemporaryDirectory() as tmp:
            libs = build(texts, Path(tmp), args.kernel)
            print(f"built {len(libs)} variants in {time.perf_counter() - start:.1f} s", flush=True)
            result = KERNELS[args.kernel][3](libs)
            result.update(card=card, registers={k: e[1] for k, e in libs.items()})
    finally:
        module._library = package_library
    print(json.dumps({k: v for k, v in result.items() if k not in ("failed", "card")}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
