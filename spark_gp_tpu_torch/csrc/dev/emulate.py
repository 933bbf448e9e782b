"""Run a kernel source of ``csrc/`` on the CPU, for checking its indexing
before it goes to the card.

    python3 spark_gp_tpu_torch/csrc/dev/emulate.py [SOURCE.cu ...]

With no argument it runs ``csrc/streamed_matvec.cu``,
``csrc/spd_inv_logdet.cu``, ``csrc/slq_quadrature.cu`` and
``csrc/lane_gram.cu``; a source is checked as K1 if it defines
``spd_inv_logdet_f32``, as the SLQ quadrature if it defines
``slq_quadrature_f32``, as the lane gram if it defines ``lane_gram_f32``,
else as K2.  The source is translated to plain C++
(``cuda_emu.h`` runs each block as ``blockDim.x`` threads with a real
barrier and emulated warp shuffles; a launch becomes a loop over blocks,
``extern __shared__`` a pointer to the launch's buffer, NaN-filled for each
block, and each inline-PTX statement a call of the header's emulation of
that instruction), built with ``g++`` into a temporary directory, and held
against the plain float64 versions:
- K2 and K2-VJP (``ops/streamed_matvec.py``) on ragged shapes, every
  accumulator width, p over one feature chunk, an odd count of row tiles
  (the VJP's off-diagonal tile pairs), two experts (a VJP block's run of
  tile pairs crosses from one to the next: the emulation reports one SM)
  and right-hand sides in chunks; bars 1e-5 and 1e-4 of the largest
  value, every VJP partial sum written (they start NaN);
- K1 (``ops/spd_linalg.py``) at n = 4 .. 128 (ragged last panels, a full
  128) and on the workspace path (n = 129, 200, 256, with the workspace
  the entry asks for, NaN-filled), on batches of two kinds of SPD matrix,
  and batches with a non-PD matrix at n = 100 and 300 whose batch mates
  must stay within the bar; bars K^-1 within 5e-5 of max|K^-1|, logdet within
  1e-4 + 1e-5 |logdet|;
- the SLQ quadrature (``ops/slq_quadrature.py``) on Lanczos tridiagonals of
  real PCG runs (t = 1, 20, 64, 65, 100, float32 and float64; one run past
  its convergence, whose frozen steps split T) and on the cases of
  ``SLQ_SPECIAL`` (T split at row 0 and mid-matrix, a float64 run far past
  convergence whose Ritz values repeat, a spectrum of condition ~1e6, t =
  2, t = 1100 over the workspace, an indefinite T, a NaN batch mate),
  against the float64 ``eigh`` route: within 1e-5 of max(1, |value|)
  (float32 inputs) and 1e-10 (float64), every matrix's work counted, the
  workspace NaN-filled;
- the lane gram (``ops/lane_gram.py``) on ``LANE_CASES`` (ragged tiles, p
  over one staged chunk, p = 1, self-grams, inner products) in both
  modes, against its plain float32 version on the same inputs: within
  1e-5 of the case's scale (max |x1|^2 + max |x2|^2, or max |x1| max |x2|
  for inner products), every entry written, self-gram diagonals exactly 0.
  The emulation's ``mma.sync`` sums each 8-term product in order.
This checks tiling, staging and bounds; it says nothing about speed, and
nvcc may still refuse what g++ takes.  Exits 1 if a case misses its bar.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from spark_gp_tpu_torch.ops import iterative as it_ops  # noqa: E402
from spark_gp_tpu_torch.ops import lane_gram as lg  # noqa: E402
from spark_gp_tpu_torch.ops import slq_quadrature as sq  # noqa: E402
from spark_gp_tpu_torch.ops import spd_linalg as spd  # noqa: E402
from spark_gp_tpu_torch.ops import streamed_matvec as sm  # noqa: E402

FAMILIES = {"rbf": [0.7], "matern12": [0.8], "matern32": [0.8], "matern52": [0.8],
            "rq": [0.9, 1.3], "dot": [0.5], "poly": [0.7]}
#: (shape, n): ragged s, s below one tile, p over one feature chunk, every
#: width, three row tiles (off-diagonal tile pairs), two experts
CASES = [((2, 100, 5), 1), ((2, 100, 5), 4), ((2, 100, 5), 8), ((1, 100, 5), 9),
         ((2, 77, 21), 9), ((1, 33, 3), 9), ((1, 64, 9), 9), ((1, 130, 20), 17),
         ((1, 5, 2), 3), ((1, 96, 16), 16), ((1, 40, 33), 2), ((1, 130, 5), 1),
         ((1, 130, 5), 8), ((2, 130, 5), 8), ((1, 130, 5), 16)]
#: K1 (batch, n): one panel, ragged last panels (60, 97, 100, 113), a full
#: 128; the workspace path at 129, a ragged 200 and a whole-tile 256
K1_CASES = [(2, 4), (2, 16), (2, 60), (2, 97), (2, 100), (1, 113), (1, 128), (1, 129),
            (2, 200), (2, 256)]


def _close(text: str, i: int) -> int:
    """Index just past the bracket that closes the one opened at ``i``,
    skipping string literals."""
    depth, quote = 0, False
    for j in range(i, len(text)):
        ch = text[j]
        if quote:
            quote = ch != '"' or text[j - 1] == "\\"
        elif ch == '"':
            quote = True
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if not depth:
                return j + 1
    raise SystemExit("emulate.py: unbalanced brackets")


def _split(text: str, sep: str) -> list[str]:
    """``text`` split at ``sep`` outside brackets and string literals."""
    parts, depth, quote, start = [], 0, False, 0
    for j, ch in enumerate(text):
        if quote:
            quote = ch != '"' or text[j - 1] == "\\"
        elif ch == '"':
            quote = True
        elif ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == sep and not depth:
            parts.append(text[start:j])
            start = j + 1
    return parts + [text[start:]]


def _asm_call(body: str) -> str:
    """One inline-PTX statement as a call of its emulation in
    ``cuda_emu.h``: ``emu_<instruction, dots as underscores>(operands)``,
    the instruction's operands in its own order, ``%k`` replaced by the
    k-th C++ operand (outputs first)."""
    sections = _split(body, ":")
    template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', sections[0]))
    template = template.split(";")[0].replace("\\n", " ").strip()
    exprs = [op[op.index("("):].strip()[1:-1]
             for section in sections[1:3] for op in _split(section, ",") if op.strip()]
    mnemonic, _, args = template.partition(" ")
    args = [re.sub(r"%(\d+)", lambda m: f"({exprs[int(m.group(1))]})", a).strip(" []{}")
            for a in args.split(",") if a.strip()]
    return f"emu_{mnemonic.replace('.', '_')}({', '.join(args)});"


def translate(text: str) -> str:
    """CUDA source -> C++ for ``cuda_emu.h``."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    # extern __shared__ [__align__(n)] T name[];  ->  T* name = the launch's buffer
    text = re.sub(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];",
                  r"\1* \2 = static_cast<\1*>(emu_dynamic_shared());", text)
    # kernel<<<cfg>>>(args);  ->  emu_launch([&] { kernel(args); }, cfg);
    text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"emu_launch([&] {{ {m.group(1)}({m.group(3)}); }}, {m.group(2)});",
                  text, flags=re.S)
    out = []
    while (m := re.search(r"\basm\s*(?:volatile\s*)?\(", text)):
        end = _close(text, m.end() - 1)
        out += [text[: m.start()], _asm_call(text[m.end(): end - 1])]
        text = text[end:].lstrip(";")
    return "".join(out) + text


def is_k1(source: Path) -> bool:
    return "spd_inv_logdet_f32" in source.read_text()


def is_slq(source: Path) -> bool:
    return "slq_quadrature_f32" in source.read_text()


def is_lane(source: Path) -> bool:
    return "lane_gram_f32" in source.read_text()


def binder(source: Path):
    """The wrapper module's ``bind`` for the source's entry points."""
    if is_lane(source):
        return lg.bind
    return spd.bind if is_k1(source) else sq.bind if is_slq(source) else sm.bind


def build(source: Path, out: Path) -> ctypes.CDLL:
    """The emulated library of ``source``, its entry points declared.
    Each library keeps its own copy of the header's globals
    (``-fno-gnu-unique``), so K1's and K2's can share a process."""
    cpp = out.with_suffix(".cpp")
    cpp.write_text(translate(source.read_text()))
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-fno-gnu-unique",
           "-Wall", "-Wno-unused-function", "-Wno-unknown-pragmas", "-I", str(HERE),
           "-o", str(out), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    return binder(source)(ctypes.CDLL(str(out)))


def stack(shape, n, rng):
    """float32 ``x [b, s, p]`` (features scaled by p^-1/2), ``v`` and ``w
    [b, s, n]``."""
    b, s, p = shape
    x = (rng.normal(size=shape) / np.sqrt(p)).astype(np.float32)
    v, w = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    return x, v, w


def vjp_partials(lib, x, w, v, par, fid: int, spare: int = 0) -> np.ndarray:
    """The VJP entry's partial sums: ``[streamed_matvec_vjp_blocks + spare,
    2]``, NaN before the call, so a pair never written, or one written past
    the count, shows.  The squared-norm scratch starts NaN too."""
    b, s, p = x.shape
    n = v.shape[-1]
    part = np.full((lib.streamed_matvec_vjp_blocks(b, s, n) + spare, 2), np.nan, np.float32)
    sqn = np.full((b, s), np.nan, np.float32)
    err = lib.streamed_matvec_vjp_f32(x.ctypes.data, w.ctypes.data, v.ctypes.data,
                                      par.ctypes.data, sqn.ctypes.data, part.ctypes.data, b, s,
                                      p, n, fid, 2, None)
    if err:
        raise SystemExit(f"VJP entry returned {err} at {x.shape} n={n}")
    return part


def check(lib, shape, n, family, params, rng) -> tuple[float, float]:
    """Relative errors of both entries against the plain float64 versions."""
    b, s, p = shape
    spec = sm.TILE_TRANSFORMS[family]
    x, v, w = stack(shape, n, rng)
    par = np.array(params, np.float32)
    out = np.full((b, s, n), np.nan, np.float32)
    sqn = np.empty((b, s), np.float32)
    err = lib.streamed_matvec_f32(x.ctypes.data, v.ctypes.data, par.ctypes.data, sqn.ctypes.data,
                                  out.ctypes.data, b, s, p, n, spec.fid, 2, None)
    if err:
        raise SystemExit(f"entry returned {err} at {shape} n={n}")
    part = vjp_partials(lib, x, w, v, par, spec.fid)
    x64, v64, p64 = (torch.as_tensor(a).double() for a in (x, v, par))
    ref = sm.streamed_matvec_plain(x64, v64, family, p64, 2).numpy()
    gref = sm.streamed_matvec_vjp_plain(x64, torch.as_tensor(w).double(), v64, family, p64,
                                        2).numpy()
    grad = part.astype(np.float64).sum(0)[: spec.n_params]
    return (float(np.abs(out - ref).max() / np.abs(ref).max()),
            float(np.abs(grad - gref).max() / np.abs(gref).max()))


def spd_stack(b: int, n: int, rng, kind: str) -> np.ndarray:
    """``[b, n, n]`` float32 SPD: ``"wishart"``, A A^T + n I (condition
    number ~5); ``"gram"``, an RBF gram of points in 3-D plus 0.1 I
    (condition number up to ~1e2 at n = 128, inverse entries of order 10)."""
    if kind == "wishart":
        a = rng.normal(size=(b, n, n))
        k = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    else:
        x = rng.normal(size=(b, n, 3))
        d = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
        k = np.exp(-0.5 * d) + 0.1 * np.eye(n)
    return k.astype(np.float32)


def workspace(lib, b: int, n: int):
    """The workspace the entry asks for at ``(b, n)``, NaN-filled so a read
    of a word never written shows; ``None`` when it asks for none."""
    floats = lib.spd_inv_logdet_workspace_floats(b, n)
    return np.full(floats, np.nan, np.float32) if floats else None


def check_spd(lib, k: np.ndarray) -> tuple[float, np.ndarray]:
    """K1 on ``k`` against the plain float64 version: the error of K^-1
    relative to max|K^-1| over the finite matrices of the batch, and each
    matrix's logdet error over its bar 1e-4 + 1e-5 |logdet| (NaN where the
    plain version gives NaN)."""
    b, n = k.shape[:2]
    kinv = np.full_like(k, np.nan)
    ld = np.full(b, np.nan, np.float32)
    ws = workspace(lib, b, n)
    err = lib.spd_inv_logdet_f32(k.ctypes.data, kinv.ctypes.data, ld.ctypes.data,
                                 None if ws is None else ws.ctypes.data, b, n, None)
    if err:
        raise SystemExit(f"entry returned {err} at ({b}, {n})")
    ref, ld_ref = (a.numpy() for a in spd.spd_inv_logdet_plain(torch.as_tensor(k).double()))
    finite = np.isfinite(ld_ref)
    diff = np.abs(kinv[finite] - ref[finite]).max() if finite.any() else 0.0
    rel = float(diff / np.abs(ref[finite]).max()) if finite.any() else 0.0
    ld_rel = np.abs(ld - ld_ref) / (1e-4 + 1e-5 * np.abs(ld_ref))
    if not np.array_equal(np.isfinite(ld), finite) or not np.array_equal(
            np.isfinite(kinv).all(axis=(1, 2)), finite):
        rel = float("inf")  # NaN where the plain version is finite, or the reverse
    return rel, ld_rel


def lanczos_stack(b: int, s: int, t: int, rng, dtype=np.float32, tol: float = 1e-12,
                  jitter: float = 0.1):
    """``(diag [b, r, t], off [b, r, t - 1])`` of the Lanczos tridiagonals
    of a PCG run of ``t`` steps on ``b`` SPD grams (RBF of points in 2-D
    plus ``jitter`` I) against 8 Gaussian right-hand sides, unpreconditioned,
    columns freezing under ``tol`` (0: never): what ``ops/iterative.py``
    hands the quadrature."""
    x = rng.normal(size=(b, s, 2))
    d = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    k = torch.as_tensor(np.exp(-0.5 * d) + jitter * np.eye(s))
    z = torch.as_tensor(rng.normal(size=(b, s, 8)))
    res = it_ops.batched_pcg(lambda v: k @ v, z, None, t, tol)
    diag, off = sq.lanczos_tridiagonal(res.alphas, res.betas)
    return diag.numpy().astype(dtype), off.numpy().astype(dtype)


def spd_tridiagonal(b: int, t: int, rng, dtype=np.float64):
    """``b`` random diagonally dominant (so SPD, no negligible coupling)
    tridiagonals of ``t`` rows: diagonal in [2, 3), off-diagonal in
    [0.1, 0.9)."""
    diag = 2.0 + rng.random((b, t))
    off = 0.1 + 0.8 * rng.random((b, t - 1))
    return diag.astype(dtype), off.astype(dtype)


def slq_special(name: str, dtype, rng):
    """The ``(diag, off)`` stack of one case of ``SLQ_SPECIAL``."""
    if name in ("split-row-0", "split-mid"):
        diag, off = lanczos_stack(2, 100, 64, rng, dtype)
        off[..., 0 if name == "split-row-0" else 31] = 0.0
        return diag, off
    if name == "past-convergence":  # 64 steps on 20 rows: Ritz values repeat
        return lanczos_stack(1, 20, 64, rng, dtype, tol=0.0)
    if name == "wide-spectrum":  # condition number ~1e6
        return lanczos_stack(1, 100, 64, rng, dtype, jitter=4e-5)
    if name == "t2":
        return lanczos_stack(2, 30, 2, rng, dtype)
    if name == "workspace":
        return spd_tridiagonal(2, 1100, rng, dtype)
    if name == "indefinite":  # shifted down by 1: eigenvalues below the clamp
        diag, off = lanczos_stack(1, 30, 20, rng, dtype)
        return diag - dtype(1.0), off
    if name == "nan-mate":
        diag, off = lanczos_stack(1, 30, 20, rng, dtype)
        diag[0, 3, 5] = np.nan
        return diag, off
    raise KeyError(name)


def check_slq(lib, diag: np.ndarray, off: np.ndarray) -> tuple[float, np.ndarray]:
    """The quadrature entry on ``(diag, off)`` against the float64 eigh
    route on the same inputs: the largest error over max(1, |value|) over
    the matrices of finite entries (NaN expected of the others; a NaN where
    it is not expected, or a finite value where it is, is an infinite
    error), and each matrix's work count
    (NaN-filled output, -1 counts and a NaN-filled workspace before the
    call, so an entry never written, or a workspace word read before it is
    written, shows)."""
    t = diag.shape[-1]
    d = np.ascontiguousarray(diag.reshape(-1, t))
    o = np.ascontiguousarray(off.reshape(d.shape[0], t - 1))
    out = np.full(d.shape[0], np.nan, dtype=diag.dtype)
    steps = np.full(d.shape[0], -1, dtype=np.int32)
    work = np.full(lib.slq_quadrature_workspace_doubles(d.shape[0], t), np.nan)
    entry = lib.slq_quadrature_f32 if diag.dtype == np.float32 else lib.slq_quadrature_f64
    err = entry(d.ctypes.data, o.ctypes.data, out.ctypes.data, steps.ctypes.data,
                work.ctypes.data, d.shape[0], t, None)
    if err:
        raise SystemExit(f"entry returned {err} at {diag.shape}")
    finite = np.isfinite(d).all(-1) & np.isfinite(o).all(-1)
    ref = np.full(d.shape[0], np.nan)
    ref[finite] = sq.slq_quadrature_plain(torch.as_tensor(d[finite]).double(),
                                          torch.as_tensor(o[finite]).double()).numpy()
    if not np.array_equal(np.isfinite(out), finite):
        return float("inf"), steps
    rel = np.abs(out[finite] - ref[finite]) / np.maximum(1.0, np.abs(ref[finite]))
    return float(rel.max(initial=0.0)), steps


#: (experts, rows, PCG steps): one step, the iris B systems' t = 20, the
#: main path's t = 64, 64 steps on 30 rows (converged early: frozen steps
#: split T), and t = 65 and 100 (``GP_SOLVER_MAX_ITERS`` over 64)
SLQ_CASES = [(2, 30, 1), (3, 20, 20), (2, 100, 64), (1, 64, 64), (2, 30, 64), (1, 80, 65),
             (1, 150, 100)]
#: the cases of :func:`slq_special`
SLQ_SPECIAL = ["split-row-0", "split-mid", "past-convergence", "wide-spectrum", "t2",
               "workspace", "indefinite", "nan-mate"]


def main_slq(lib, rng) -> int:
    failed = 0
    cases = [(f"({b}, {s}, t={t})", lambda dt, c=(b, s, t): lanczos_stack(*c, rng, dt))
             for b, s, t in SLQ_CASES]
    cases += [(name, lambda dt, n=name: slq_special(n, dt, rng)) for name in SLQ_SPECIAL]
    for label, make in cases:
        for dtype, bar in ((np.float32, 1e-5), (np.float64, 1e-10)):
            rel, steps = check_slq(lib, *make(dtype))
            ok = rel <= bar and bool((steps >= 0).all())
            failed += not ok
            print(f"{'ok  ' if ok else 'FAIL'} SLQ {label} {np.dtype(dtype).name}: "
                  f"{rel:.2e}, work {int(steps.sum())}", flush=True)
    return failed


#: (batch, n1, n2, p, self-gram, inner products): ragged tiles, 2 x 2
#: tiles, p over one staged chunk, p = 1 (the Synthetics width), a full
#: tile, the airfoil fold's ARD self-gram
LANE_CASES = [(2, 37, 45, 5, False, False), (3, 70, 70, 9, True, False),
              (1, 20, 130, 33, False, True), (1, 18, 100, 1, False, False),
              (1, 64, 64, 8, True, False), (2, 97, 97, 5, True, False),
              (1, 3, 70, 40, False, False)]


def check_lane(lib, case, mode: str, rng) -> tuple[float, bool]:
    """The entry on one case against :func:`lane_gram_plain`: the largest
    error over the case's scale (infinite where an entry stayed NaN), and
    whether a self-gram's diagonal is exactly 0."""
    b, n1, n2, p, self_gram, inner = case
    x1 = rng.normal(size=(b, n1, p)).astype(np.float32)
    x2 = x1 if self_gram else rng.normal(size=(b, n2, p)).astype(np.float32)
    out = np.full((b, n1, n2), np.nan, np.float32)
    flags = (1 if self_gram else 0) | (2 if inner else 0)
    err = lib.lane_gram_f32(x1.ctypes.data, x2.ctypes.data, out.ctypes.data, b, n1, n2, p,
                            lg.MODES[mode], flags, None)
    if err:
        raise SystemExit(f"entry returned {err} at {case}")
    ref = lg.lane_gram_plain(torch.as_tensor(x1), torch.as_tensor(x2), mode, self_gram,
                             inner).numpy()
    sq1, sq2 = (np.sum(x.astype(np.float64) ** 2, -1).max() for x in (x1, x2))
    scale = np.sqrt(sq1 * sq2) if inner else sq1 + sq2
    rel = float(np.abs(out - ref).max() / scale) if np.isfinite(out).all() else float("inf")
    diag_ok = not self_gram or bool((np.diagonal(out, axis1=1, axis2=2) == 0.0).all())
    return rel, diag_ok


def main_lane(lib, rng) -> int:
    failed = 0
    for case in LANE_CASES:
        for mode in lg.MODES:
            rel, diag_ok = check_lane(lib, case, mode, rng)
            ok = rel <= 1e-5 and diag_ok
            failed += not ok
            print(f"{'ok  ' if ok else 'FAIL'} lane_gram {case} {mode}: {rel:.2e}"
                  f"{'' if diag_ok else ', diagonal not 0'}", flush=True)
    return failed


def main_k1(lib, rng) -> int:
    failed = 0
    print("smem max n", lib.spd_inv_logdet_smem_max_n())
    for b, n in K1_CASES:
        for kind in ("wishart", "gram"):
            rel, ld_rel = check_spd(lib, spd_stack(b, n, rng, kind))
            ok = rel <= 5e-5 and bool((ld_rel <= 1).all())
            failed += not ok
            print(f"{'ok  ' if ok else 'FAIL'} K1 ({b}, {n}) {kind}: K^-1 {rel:.2e}  "
                  f"logdet/bar {ld_rel.max():.2e}", flush=True)
    for n in (100, 300):
        k = spd_stack(3, n, rng, "wishart")
        k[1, 0, 0] = -1.0
        rel, ld_rel = check_spd(lib, k)
        ok = rel <= 5e-5 and bool((ld_rel[[0, 2]] <= 1).all())
        failed += not ok
        print(f"{'ok  ' if ok else 'FAIL'} K1 non-PD batch mate at n = {n}: K^-1 {rel:.2e}",
              flush=True)
    return failed


def main_k2(lib, rng) -> int:
    failed = 0
    print("row tile", lib.streamed_matvec_row_tile())
    for shape, n in CASES:
        for family, params in FAMILIES.items():
            e_mv, e_vjp = check(lib, shape, n, family, params, rng)
            ok = e_mv <= 1e-5 and e_vjp <= 1e-4
            failed += not ok
            print(f"{'ok  ' if ok else 'FAIL'} {shape} n={n} {family}: "
                  f"K2 {e_mv:.2e}  VJP {e_vjp:.2e}", flush=True)
    return failed


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source", nargs="*",
                        default=[str(HERE.parent / "streamed_matvec.cu"),
                                 str(HERE.parent / "spd_inv_logdet.cu"),
                                 str(HERE.parent / "slq_quadrature.cu"),
                                 str(HERE.parent / "lane_gram.cu")])
    args = parser.parse_args()
    rng = np.random.default_rng(0)
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, source in enumerate(map(Path, args.source)):
            lib = build(source, Path(tmp) / f"libemu{i}.so")
            main_of = (main_k1 if is_k1(source) else main_slq if is_slq(source)
                       else main_lane if is_lane(source) else main_k2)
            failed += main_of(lib, rng)
    print(f"{failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
