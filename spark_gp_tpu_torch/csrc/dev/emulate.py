"""Run ``csrc/streamed_matvec.cu`` on the CPU, for checking a kernel's
indexing before it goes to the card.

    python3 spark_gp_tpu_torch/csrc/dev/emulate.py [SOURCE.cu]

The source is translated to plain C++ (``cuda_emu.h`` runs each block as
``blockDim.x`` threads with a real barrier and emulated warp shuffles;
a launch becomes a loop over blocks and each inline-PTX statement a call
of the header's emulation of that instruction), built with
``g++`` into a temporary directory, and both entry points are held
against the plain float64 versions of ``ops/streamed_matvec.py`` on
ragged shapes, every accumulator width and p over one feature chunk.
This checks tiling, staging and bounds; it says nothing about speed, and
nvcc may still refuse what g++ takes.  Exits 1 if a case misses its bar
(K2 1e-5 and the VJP 1e-4 of the largest value).
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

from spark_gp_tpu_torch.ops import streamed_matvec as sm  # noqa: E402

FAMILIES = {"rbf": [0.7], "matern12": [0.8], "matern32": [0.8], "matern52": [0.8],
            "rq": [0.9, 1.3], "dot": [0.5], "poly": [0.7]}
#: (shape, n): ragged s, s below one tile, p over one feature chunk, every width
CASES = [((2, 100, 5), 1), ((2, 100, 5), 4), ((2, 100, 5), 8), ((1, 100, 5), 9),
         ((2, 77, 21), 9), ((1, 33, 3), 9), ((1, 64, 9), 9), ((1, 130, 20), 17),
         ((1, 5, 2), 3), ((1, 96, 16), 16), ((1, 40, 33), 2)]


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
    args = [re.sub(r"%(\d+)", lambda m: f"({exprs[int(m.group(1))]})", a).strip(" []")
            for a in args.split(",") if a.strip()]
    return f"emu_{mnemonic.replace('.', '_')}({', '.join(args)});"


def translate(text: str) -> str:
    """CUDA source -> C++ for ``cuda_emu.h``."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
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


def build(source: Path, out: Path) -> ctypes.CDLL:
    cpp = out.with_suffix(".cpp")
    cpp.write_text(translate(source.read_text()))
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wall",
           "-Wno-unused-function", "-Wno-unknown-pragmas", "-I", str(HERE), "-o", str(out),
           str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    return sm.bind(ctypes.CDLL(str(out)))


def check(lib, shape, n, family, params, rng) -> tuple[float, float]:
    """Relative errors of both entries against the plain float64 versions."""
    b, s, p = shape
    spec = sm.TILE_TRANSFORMS[family]
    x = (rng.normal(size=shape) / np.sqrt(p)).astype(np.float32)
    v, w = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    par = np.array(params, np.float32)
    out = np.full((b, s, n), np.nan, np.float32)
    sqn = np.empty((b, s), np.float32)
    err = lib.streamed_matvec_f32(x.ctypes.data, v.ctypes.data, par.ctypes.data, sqn.ctypes.data,
                                  out.ctypes.data, b, s, p, n, spec.fid, 2, None)
    part = np.zeros((lib.streamed_matvec_vjp_blocks(b, s, n), 2), np.float32)
    err |= lib.streamed_matvec_vjp_f32(x.ctypes.data, w.ctypes.data, v.ctypes.data,
                                       par.ctypes.data, part.ctypes.data, b, s, p, n, spec.fid,
                                       2, None)
    if err:
        raise SystemExit(f"entry returned {err} at {shape} n={n}")
    x64, v64, p64 = (torch.as_tensor(a).double() for a in (x, v, par))
    ref = sm.streamed_matvec_plain(x64, v64, family, p64, 2).numpy()
    gref = sm.streamed_matvec_vjp_plain(x64, torch.as_tensor(w).double(), v64, family, p64,
                                        2).numpy()
    grad = part.astype(np.float64).sum(0)[: spec.n_params]
    return (float(np.abs(out - ref).max() / np.abs(ref).max()),
            float(np.abs(grad - gref).max() / np.abs(gref).max()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source", nargs="?", default=str(HERE.parent / "streamed_matvec.cu"))
    args = parser.parse_args()
    rng = np.random.default_rng(0)
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(args.source), Path(tmp) / "libemu.so")
        print("row tile", lib.streamed_matvec_row_tile())
        for shape, n in CASES:
            for family, params in FAMILIES.items():
                e_mv, e_vjp = check(lib, shape, n, family, params, rng)
                ok = e_mv <= 1e-5 and e_vjp <= 1e-4
                failed += not ok
                print(f"{'ok  ' if ok else 'FAIL'} {shape} n={n} {family}: "
                      f"K2 {e_mv:.2e}  VJP {e_vjp:.2e}", flush=True)
    print(f"{failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
