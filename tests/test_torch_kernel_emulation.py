"""The CUDA sources of K1, K2 and K2-VJP (``csrc/*.cu``) on the CPU.

``csrc/dev/emulate.py`` translates a source to C++ over an emulation of
the CUDA subset it uses (each block as real threads with a barrier, warp
shuffles, dynamic shared memory NaN-filled for each block, ``cp.async`` as
a plain copy) and builds it with g++.  K2 and K2-VJP are held against the
plain float64 version at the card's bars (K2 1e-5 and the VJP 1e-4 of the
largest value) on shapes that exercise ragged tiles, every accumulator
width, two feature chunks and two right-hand-side chunks; the VJP also on
three row tiles (off-diagonal tile pairs of its symmetric walk), on two
experts at n = 1 and 8 (a block's run of tile pairs crosses from one to
the next), on runs of two tile pairs in two right-hand-side chunks each
(the row tile restaged every step), for the count of partial sums it
writes and for bit-identical partials over two calls.  The emulation
reports one SM, so the VJP's grid is four blocks.  K1 is held
against its plain float64 version at the card's bars (K^-1 within 5e-5 of
max|K^-1|, logdet within 1e-4 + 1e-5 |logdet|) at n from one panel to a
full 128 with ragged last panels, on the tiled workspace path (n = 129, a
ragged 200, a whole-tile 256, batches of two, every matrix over many
blocks), and on batches with a non-PD matrix on both paths.  The SLQ
quadrature kernel (``csrc/slq_quadrature.cu``) and its first design
(``csrc/dev/slq_quadrature_first.cu``) are held against the float64
``eigh`` route on the Lanczos tridiagonals of real PCG runs (t = 1, 20,
64, 65 and 100; one run past its convergence, whose frozen steps split T)
and on ``emulate.SLQ_SPECIAL`` (splits at row 0 and mid-matrix, repeated
Ritz values far past convergence, condition ~1e6, t = 2, t = 1100 over the
workspace, an indefinite T, a NaN batch mate), float32 within 1e-5 of
max(1, |value|) and float64 within 1e-10, every output and work count
written, the workspace NaN-filled.  The lane gram (``csrc/lane_gram.cu``,
its ``mma.sync.m16n8k8`` TF32 tiles emulated fragment by fragment) is
held against its plain float32 version in both modes on
``emulate.LANE_CASES`` (ragged tiles, p over one staged chunk, p = 1,
self-grams, inner products) within 1e-5 of max |x1|^2 + max |x2|^2 (or
max |x1| max |x2|), every entry written, self-gram diagonals exactly 0.
This covers the kernels' tiling, staging,
barriers and bounds here; their speed, and what only nvcc refuses, show
on the card.
"""

import _torch_env  # noqa: F401  (one PyTorch thread per test process)
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_gp_tpu_torch.ops import slq_quadrature as sq
from spark_gp_tpu_torch.ops import spd_linalg as spd
from spark_gp_tpu_torch.ops import streamed_matvec as sm

EMULATE = Path(__file__).resolve().parents[1] / "spark_gp_tpu_torch" / "csrc" / "dev" / "emulate.py"


def _emulated(tmp_path_factory, source: str):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernel source")
    spec = importlib.util.spec_from_file_location("kernel_emulate", EMULATE)
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    lib = emu.build(emu.HERE.parent / f"{source}.cu",
                    tmp_path_factory.mktemp("emulated") / f"lib{Path(source).name}.so")
    return emu, lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulated(tmp_path_factory, "streamed_matvec")


@pytest.fixture(scope="module")
def emulated_k1(tmp_path_factory):
    return _emulated(tmp_path_factory, "spd_inv_logdet")


def test_row_tile_agrees_with_the_wrapper(emulated):
    _, lib = emulated
    assert lib.streamed_matvec_row_tile() == sm.ROW_TILE


@pytest.mark.parametrize("shape,n", [((2, 70, 5), 1), ((1, 70, 5), 4), ((1, 70, 5), 8),
                                     ((1, 70, 5), 9), ((1, 70, 21), 9), ((1, 20, 20), 17),
                                     ((1, 5, 2), 3), ((1, 130, 5), 1), ((1, 130, 5), 8),
                                     ((2, 100, 5), 8), ((1, 130, 5), 16)])
def test_kernel_source_matches_plain(emulated, shape, n):
    emu, lib = emulated
    rng = np.random.default_rng(sum(shape) + n)
    for family, params in emu.FAMILIES.items():
        e_mv, e_vjp = emu.check(lib, shape, n, family, params, rng)
        assert e_mv <= 1e-5 and e_vjp <= 1e-4, (family, e_mv, e_vjp)


def test_vjp_writes_exactly_the_partials_it_reports(emulated):
    """Every one of the ``streamed_matvec_vjp_blocks`` partial pairs is
    written and none past them (the buffer starts NaN): one tile pair, a
    run crossing row tiles, and one crossing experts."""
    emu, lib = emulated
    rng = np.random.default_rng(5)
    par = np.array([0.7], np.float32)
    for shape, n in [((1, 5, 2), 1), ((1, 130, 5), 8), ((3, 200, 4), 1)]:
        x, v, w = emu.stack(shape, n, rng)
        blocks = lib.streamed_matvec_vjp_blocks(shape[0], shape[1], n)
        part = emu.vjp_partials(lib, x, w, v, par, sm.TILE_TRANSFORMS["rbf"].fid, spare=3)
        assert blocks >= 1 and part.shape == (blocks + 3, 2)
        assert np.isfinite(part[:blocks]).all(), shape
        assert np.isnan(part[blocks:]).all(), shape


def test_vjp_partials_are_bit_identical_over_two_calls(emulated):
    """Each block sums its run in a fixed order, so two calls on the same
    inputs give the same partials to the bit."""
    emu, lib = emulated
    x, v, w = emu.stack((2, 130, 5), 8, np.random.default_rng(6))
    par = np.array([0.9, 1.3], np.float32)
    fid = sm.TILE_TRANSFORMS["rq"].fid
    first = emu.vjp_partials(lib, x, w, v, par, fid)
    assert np.isfinite(first).all()
    assert np.array_equal(first, emu.vjp_partials(lib, x, w, v, par, fid))


def test_k1_smem_max_n_agrees_with_the_source(emulated_k1):
    _, lib = emulated_k1
    assert lib.spd_inv_logdet_smem_max_n() == 128
    assert lib.spd_inv_logdet_smem_max_n() < spd.N_MAX


@pytest.mark.parametrize("b,n", [(2, 4), (2, 16), (2, 60), (2, 97), (2, 100), (1, 113),
                                 (1, 128), (1, 129), (2, 200), (2, 256)])
@pytest.mark.parametrize("kind", ["wishart", "gram"])
def test_k1_source_matches_plain(emulated_k1, b, n, kind):
    emu, lib = emulated_k1
    rel, ld_rel = emu.check_spd(lib, emu.spd_stack(b, n, np.random.default_rng(n), kind))
    assert rel <= 5e-5, rel
    assert (ld_rel <= 1).all(), ld_rel


def _entry(emu, lib, k):
    """The C entry on ``k`` with the workspace it asks for: (K^-1, logdet)."""
    b, n = k.shape[:2]
    kinv = np.zeros_like(k)
    ld = np.zeros(b, np.float32)
    ws = emu.workspace(lib, b, n)
    assert lib.spd_inv_logdet_f32(k.ctypes.data, kinv.ctypes.data, ld.ctypes.data,
                                  None if ws is None else ws.ctypes.data, b, n, None) == 0
    return kinv, ld


def test_k1_non_pd_matrix_is_nan_and_alone(emulated_k1):
    emu, lib = emulated_k1
    # n = 200: the workspace path, where each matrix spans many blocks
    for n in (100, 200):
        k = emu.spd_stack(3, n, np.random.default_rng(1), "wishart")
        k[1, 0, 0] = -1.0
        kinv, ld = _entry(emu, lib, k)
        assert np.isfinite(kinv).all(axis=(1, 2)).tolist() == [True, False, True], n
        assert np.isfinite(ld).tolist() == [True, False, True], n
        # the batch mates within the bars of check_spd
        ref, ld_ref = (a.numpy() for a in
                       spd.spd_inv_logdet_plain(torch.as_tensor(k[[0, 2]]).double()))
        assert np.abs(kinv[[0, 2]] - ref).max() <= 5e-5 * np.abs(ref).max(), n
        assert (np.abs(ld[[0, 2]] - ld_ref) <= 1e-4 + 1e-5 * np.abs(ld_ref)).all(), n


def test_k1_output_is_exactly_symmetric(emulated_k1):
    emu, lib = emulated_k1
    for n in (97, 100, 200):
        kinv, _ = _entry(emu, lib, emu.spd_stack(1, n, np.random.default_rng(n), "gram"))
        assert np.array_equal(kinv, kinv.transpose(0, 2, 1)), n


def test_k1_workspace_size_query(emulated_k1):
    """No workspace at n <= 128; above it at least the [B, n, n] working
    copy, growing with the batch."""
    _, lib = emulated_k1
    assert lib.spd_inv_logdet_workspace_floats(5, 128) == 0
    for n in (129, 200, 512):
        one = lib.spd_inv_logdet_workspace_floats(1, n)
        assert one >= n * n and lib.spd_inv_logdet_workspace_floats(3, n) == 3 * one


@pytest.fixture(scope="module")
def emulated_slq(tmp_path_factory):
    return _emulated(tmp_path_factory, "slq_quadrature")


@pytest.fixture(scope="module")
def emulated_slq_first(tmp_path_factory):
    return _emulated(tmp_path_factory, "dev/slq_quadrature_first")


def test_slq_t_max_agrees_with_the_wrapper(emulated_slq):
    """The source has no largest t: up to 1024 rows a block keeps T in
    shared memory and asks for no workspace, above it for 3 t doubles a
    matrix, which the wrapper allocates at the size the library asks for;
    the wrapper takes any t >= 1."""
    _, lib = emulated_slq
    for batch, t in ((72, 1), (72, 64), (72, 65), (72, 1024)):
        assert lib.slq_quadrature_workspace_doubles(batch, t) == 0
    for batch, t in ((72, 1025), (3, 4096)):
        assert lib.slq_quadrature_workspace_doubles(batch, t) == 3 * batch * t
    meta = torch.empty(9, 8, 100, device="meta")
    assert not sq.kernel_applies(meta) and not sq.kernel_applies(torch.zeros(2, 100))


SLQ_CASES = [(2, 30, 1), (3, 20, 20), (2, 100, 64), (1, 64, 64), (2, 30, 64), (1, 80, 65),
             (1, 150, 100)]


@pytest.mark.parametrize("b,s,t", SLQ_CASES)
@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-5), (np.float64, 1e-10)])
def test_slq_source_matches_the_eigh_route(emulated_slq, b, s, t, dtype, bar):
    emu, lib = emulated_slq
    rel, steps = emu.check_slq(lib, *emu.lanczos_stack(b, s, t, np.random.default_rng(s + t),
                                                       dtype))
    assert rel <= bar, rel
    assert (steps > 0).all()


@pytest.mark.parametrize("b,s,t", SLQ_CASES)
@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-5), (np.float64, 1e-10)])
def test_slq_first_design_matches_the_eigh_route(emulated_slq_first, b, s, t, dtype, bar):
    emu, lib = emulated_slq_first
    rel, rotations = emu.check_slq(lib, *emu.lanczos_stack(b, s, t, np.random.default_rng(s + t),
                                                           dtype))
    assert rel <= bar, rel
    assert (rotations >= 0).all() and (t == 1 or rotations.sum() > 0)


@pytest.mark.parametrize("design", ["kernel", "first_design"])
@pytest.mark.parametrize("name", ["split-row-0", "split-mid", "past-convergence",
                                  "wide-spectrum", "t2", "workspace", "indefinite", "nan-mate"])
@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-5), (np.float64, 1e-10)])
def test_slq_special_cases_match_the_eigh_route(request, design, name, dtype, bar):
    emu, lib = request.getfixturevalue("emulated_slq" if design == "kernel"
                                       else "emulated_slq_first")
    rel, steps = emu.check_slq(lib, *emu.slq_special(name, dtype, np.random.default_rng(7)))
    assert rel <= bar, rel
    assert (steps >= 0).all()


@pytest.fixture(scope="module")
def emulated_lane(tmp_path_factory):
    return _emulated(tmp_path_factory, "lane_gram")


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_lane_gram_source_matches_plain(emulated_lane, case, mode):
    emu, lib = emulated_lane
    assert len(emu.LANE_CASES) == 7
    rel, diag_ok = emu.check_lane(lib, emu.LANE_CASES[case], mode, np.random.default_rng(case))
    assert rel <= 1e-5, rel
    assert diag_ok
