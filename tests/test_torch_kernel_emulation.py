"""The CUDA source of K2 and K2-VJP (``csrc/streamed_matvec.cu``) on the CPU.

``csrc/dev/emulate.py`` translates the source to C++ over an emulation of
the CUDA subset it uses (each block as real threads with a barrier, warp
shuffles, ``cp.async`` as a plain copy) and builds it with g++.  Both
entries are held against the plain float64 version at the card's bars
(K2 1e-5 and the VJP 1e-4 of the largest value) on shapes that exercise
ragged tiles, every accumulator width, two feature chunks and two
right-hand-side chunks.  This covers the kernels' tiling, staging and
bounds here; their speed, and what only nvcc refuses, show on the card.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

from spark_gp_tpu_torch.ops import streamed_matvec as sm

EMULATE = Path(__file__).resolve().parents[1] / "spark_gp_tpu_torch" / "csrc" / "dev" / "emulate.py"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernel source")
    spec = importlib.util.spec_from_file_location("k2_emulate", EMULATE)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    lib = emu.build(emu.HERE.parent / "streamed_matvec.cu",
                    tmp_path_factory.mktemp("emulated") / "libstreamed_matvec.so")
    return emu, lib


def test_row_tile_agrees_with_the_wrapper(emulated):
    _, lib = emulated
    assert lib.streamed_matvec_row_tile() == sm.ROW_TILE


@pytest.mark.parametrize("shape,n", [((2, 70, 5), 1), ((1, 70, 5), 4), ((1, 70, 5), 8),
                                     ((1, 70, 5), 9), ((1, 70, 21), 9), ((1, 20, 20), 17),
                                     ((1, 5, 2), 3)])
def test_kernel_source_matches_plain(emulated, shape, n):
    emu, lib = emulated
    rng = np.random.default_rng(sum(shape) + n)
    for family, params in emu.FAMILIES.items():
        e_mv, e_vjp = emu.check(lib, shape, n, family, params, rng)
        assert e_mv <= 1e-5 and e_vjp <= 1e-4, (family, e_mv, e_vjp)
