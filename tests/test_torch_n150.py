"""The SC-CURV crystal in isotropic eps at N=150, the upstream's finest
grid (``benchmark/configs/sc_curv_chiral_n150.json``): its configuration
and what N=150 asks of K2 (checked on the host), the port's cold solves at
the cell's four path points against the benchmark's plain complex128
reference at N=6, and K2's blocks-per-SM counter, which only the CUDA
launch feeds."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import lattices
from benchmark.reference import maxwell as ref
from pcx_torch import kernels, tracing
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig, block_width
from pcx_torch.kernels.axis_dft import axis_dft, fft_plan
from pcx_torch.kernels.gram_chunks import GRAM_CHUNK, divisor_chunk
from pcx_torch.solvers.lobpcg import Status

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = (19, 29, 39, 59)   # X, X -> M, M, R on the 80-point path
N, NEV = 6, 10
CFG = {"n": N, "lattice": "sc_curv", "diel_type": "chiral", "eps_opt": 0,
       "nev": NEV, "scal": 1.0}

# H100 (sm_90): shared memory an SM, and what the runtime reserves a block
SMEM_PER_SM, RESERVED = 228 * 1024, 1024
THREADS_PER_SM, K2_THREADS = 2048, 256


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "sc_curv_chiral_n150.json")) as f:
        return json.load(f)


def _k2_smem(a: int) -> int:
    """``smem_bytes`` of ``csrc/axis_dft.cu`` for lines of length a >= 32
    (tiles of 32 lines, two input slabs, the odd-stride output tile, the
    plan's tables and two mbarriers), 8 bytes a word."""
    n1, n2 = fft_plan(a, False)[:2]
    lines = 32
    slab = (a * lines + 15) & ~15
    return 8 * (2 * slab + lines * (a | 1) + n1 + n1 * n2 + n2 + 2)


def _k2_blocks_per_sm(a: int) -> int:
    """Blocks of K2 that fit one SM by shared memory and threads."""
    return min(SMEM_PER_SM // (_k2_smem(a) + RESERVED),
               THREADS_PER_SM // K2_THREADS)


def test_the_configuration_is_the_upstream_s_finest_grid():
    cfg = _config()
    assert (cfg["lattice"], cfg["diel_type"], cfg["eps_opt"]) == \
        ("sc_curv", "chiral", 0)
    assert (cfg["n"], cfg["nev"], cfg["block_width"], cfg["gap"]) == \
        (150, 10, 16, 20)
    assert (cfg["tol"], cfg["maxiter"], cfg["iterate"], cfg["refine"]) == \
        (1e-4, 500, "complex64", "light")
    assert cfg["guarantees"] == {"spurious_gap": 1e-3, "freq_bound": 2e-3}
    assert cfg["reduced"] == [] and set(cfg["assumed"]) == {"iterate",
                                                            "refine"}
    assert 3 * cfg["n"] ** 3 == 10_125_000


@pytest.mark.parametrize("index", POINTS)
def test_every_cell_point_takes_a_block_of_16(index):
    alpha = lattices.k_path("sc_curv", 20)[index]
    (_, rlx), _ = lattices.set_relaxation(alpha)
    assert block_width(NEV, rlx) == 16


def test_k2_plans_150_as_10_by_15():
    assert fft_plan(150, False)[:2] == (10, 15)
    assert fft_plan(150, True)[:2] == (10, 15)
    assert fft_plan(120, False)[:2] == (10, 12)


def test_k6_takes_250_column_chunks_at_n150():
    # the largest chunk <= 256 that divides D = 10,125,000
    assert divisor_chunk(3 * 150 ** 3, GRAM_CHUNK) == 250
    assert divisor_chunk(3 * 120 ** 3, GRAM_CHUNK) == 256


@pytest.mark.parametrize("a, blocks", [(100, 2), (120, 2), (144, 2),
                                       (150, 1)])
def test_k2_fits_two_blocks_an_sm_up_to_144_and_one_at_150(a, blocks):
    # 116,872 bytes a block at A=150: two with their reserves pass 228 KB
    assert _k2_blocks_per_sm(a) == blocks
    assert _k2_smem(150) == 116_872


def _operator(alpha) -> ref.Operator:
    return ref.Operator(CFG, ref.Dielectric(CFG, "cpu", cache=False), alpha,
                        "cpu")


def _dense_omega(op: ref.Operator) -> np.ndarray:
    """The lowest NEV frequencies of the reference's H, built densely (648
    columns), as ``judge`` converts its Ritz values."""
    dim = 3 * N ** 3
    cols = op.h(torch.eye(dim, dtype=torch.complex128).reshape(
        dim, 3, N, N, N)).reshape(dim, dim).T
    lam = torch.linalg.eigvalsh((cols + cols.conj().T) / 2).numpy()[:NEV]
    return ref.frequency(lam - (op.shift if op.shift > 0 else 0.0))


@pytest.fixture(scope="module")
def solver():
    return KPointSolver(ProblemConfig(n=N, lattice="sc_curv", nev=NEV),
                        device="cpu", dtype=torch.complex128)


@pytest.mark.parametrize("index", POINTS)
def test_cold_solve_matches_the_dense_reference(index, solver):
    alpha = lattices.k_path("sc_curv", 20)[index]
    r = solver.solve(alpha, seed=index)
    want = _dense_omega(_operator(alpha))
    assert r.status == Status.CONVERGED
    # complex128 on both sides at tol 1e-4: the frequencies agree to
    # rounding (measured <= 2.6e-12); a skipped band moves one by the gap
    # to the next distinct band, 3.4e-4 or more over the first 12 here
    np.testing.assert_allclose(r.omega, want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(r.omega_re, want, rtol=0, atol=1e-8)


def test_k2_counts_no_blocks_on_the_cpu():
    kernels.reset_launches()
    x = torch.randn((3, 10, 10, 10), dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(0))
    axis_dft(x)
    axis_dft(x, inverse=True)
    assert axis_dft.launches == 0 and kernels.k2_launches_by_batch() == {}
    assert "k2.sm_blocks" not in tracing.counts()
