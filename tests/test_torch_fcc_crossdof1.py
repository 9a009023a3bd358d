"""The FCC crystal in the preset-1 Hermitian eps^{-1} (the x-z pair 13
alone; ``benchmark/configs/fcc_crossdof1_n120.json``): its configuration
and the K7 instance it selects, the port's cross-DoF apply and its cold
solves at two fcc path points against the benchmark's plain complex128
reference at N=6, and the byte counters of K7's i-axis instances and of
K3, which only the CUDA launches feed."""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import lattices
from benchmark.reference import maxwell as ref
from pcx_torch import kernels, tracing
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.kernels import crossdof as k7
from pcx_torch.kernels.gram9 import bytes_moved as k3_bytes, gram9
from pcx_torch.operators import dielectric
from pcx_torch.solvers.lobpcg import Status

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NEV = 6, 10
CFG = {"n": N, "lattice": "fcc", "diel_type": "pseudochiral_crossdof",
       "eps_opt": 1, "nev": NEV, "scal": 1.0}
POINTS = (10, 17)           # the ends of the cell's X -> W chain


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "fcc_crossdof1_n120.json")) as f:
        return json.load(f)


def _op(preset: int, n: int = N, lattice: str = "fcc"):
    return dielectric.pseudochiral_crossdof_op(n, lattice, "cpu",
                                               eps_opt=preset)


def test_the_configuration_is_the_upstream_s_fcc_preset_1_library():
    cfg = _config()
    assert (cfg["lattice"], cfg["diel_type"], cfg["eps_opt"]) == \
        ("fcc", "pseudochiral_crossdof", 1)
    assert (cfg["n"], cfg["nev"], cfg["block_width"], cfg["k"],
            cfg["gap"]) == (120, 10, 16, 1, 20)
    assert (cfg["tol"], cfg["maxiter"], cfg["iterate"], cfg["refine"],
            cfg["scal"]) == (1e-4, 500, "complex64", "light", 1.0)
    assert cfg["guarantees"] == {"spurious_gap": 1e-3, "freq_bound": 2e-3}
    assert cfg["reduced"] == [] and set(cfg["assumed"]) == {"iterate",
                                                            "refine"}
    assert "bandgap_fcc1.json" in cfg["source"]
    assert len(cfg["source"]) <= 200
    assert 3 * cfg["n"] ** 3 == 5_184_000


def test_preset_1_is_pair_13_alone_and_reads_masks_0_and_2():
    op = _op(1)
    active = k7._terms(op.sten, op.eps)[0]
    assert active == 0b010 and active & k7.IAXIS
    assert k7.masks_read(active) == 2
    # pair 13: rows of component 0, columns of component 2, a forward
    # average along k then a transposed one along i, in the port and in
    # the reference alike
    row, col, axes = dielectric._PAIR_DEFS["13"]
    assert (row, col) == (0, 2) == ref.CROSS_PAIRS[1][:2]
    assert [a for a, _ in axes] == [dielectric._AX_K, dielectric._AX_I]
    assert ref.CROSS_PAIRS[1][2:] == (2, 0)
    d11, d22, d33, d12, d13, d23 = ref.PSEUDOCHIRAL_EPS[1]
    assert d11 == d33 == math.sqrt(1 + 0.875 ** 2) and d22 == 1.0
    assert (d12, d13, d23) == (0, 0.875j, 0)


def test_the_port_s_apply_equals_the_reference_s():
    op = _op(1)
    diel = ref.Dielectric(CFG, "cpu", cache=False)
    x = torch.randn((4, 3, N, N, N), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(25))
    got, want = op(x), diel(x.clone())
    # the same stencils on the same masks in complex128 (equal here,
    # measured 0): 1e-13 leaves room for a few ulps of entries of order 1
    # in another order of summation; a wrong pair, axis or mask moves
    # entries by 0.03 or more
    assert float((got - want).abs().max()) <= 1e-13
    assert float(want.abs().max()) > 0.5


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
    return KPointSolver(ProblemConfig(n=N, lattice="fcc", nev=NEV,
                                      diel_type="pseudochiral_crossdof",
                                      eps_opt=1),
                        device="cpu", dtype=torch.complex128)


@pytest.mark.parametrize("index", POINTS)
def test_cold_solve_matches_the_dense_reference(index, solver):
    alpha = lattices.k_path("fcc", 20)[index]
    r = solver.solve(alpha, seed=index)
    op = ref.Operator(CFG, ref.Dielectric(CFG, "cpu", cache=False), alpha,
                      "cpu")
    want = _dense_omega(op)
    assert r.status == Status.CONVERGED
    # complex128 on both sides at tol 1e-4: the frequencies agree to
    # rounding (measured <= 6.3e-13); a skipped band moves one by the gap
    # to the next band, 1.6e-3 or more over the first 11 here
    np.testing.assert_allclose(r.omega, want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(r.omega_re, want, rtol=0, atol=1e-8)


def test_the_cpu_paths_count_no_k7_or_k3_bytes():
    kernels.reset_launches()
    op = _op(1)
    x = torch.randn((2, 3, N, N, N), dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(3))
    k7.crossdof_apply(x, op.diag32, op.masks32, op.sten, op.eps)
    blocks = [torch.randn((16, 40), dtype=torch.complex64,
                          generator=torch.Generator().manual_seed(i))
              for i in range(6)]
    gram9(*blocks)
    counts = tracing.counts()
    assert not {"k7.bytes", "k7.iaxis_bytes", "k3.bytes"} & set(counts)
    assert kernels.launches()["crossdof_apply"] == 0
    assert kernels.launches()["gram9"] == 0


@pytest.mark.parametrize("preset,nbytes", [(0, 0),
                                           (1, 1_361_664_000),
                                           (2, 1_368_576_000),
                                           (3, 1_368_576_000)])
def test_the_i_axis_counter_takes_the_bytes_of_pairs_13_and_23(preset,
                                                               nbytes):
    """A launch adds ``bytes_moved`` to ``k7.iaxis_bytes`` where its pairs
    include 13 or 23 (presets 1-3): at m=16, N=120 the bytes ``k7.bytes``
    takes; pair 12 alone (preset 0) adds nothing."""
    op = _op(preset, n=4)
    active = k7._terms(op.sten, op.eps)[0]
    x = torch.empty((16, 3, 120, 120, 120), dtype=torch.complex64,
                    device="meta")
    added = k7.bytes_moved(x, active) if active & k7.IAXIS else 0
    assert added == nbytes


def test_k3_bytes_are_its_blocks_and_partials():
    d = 3 * 120 ** 3
    chunks = math.ceil(d / 2048)
    assert chunks == 2532
    # the six blocks alone: 3.98 GB, 1.188 ms at 3.35 TB/s
    assert k3_bytes(1, 16, d, 0) == 3_981_312_000
    assert 1e3 * k3_bytes(1, 16, d, 0) / 3.35e12 == pytest.approx(
        1.188, abs=5e-4)
    assert k3_bytes(1, 16, d, chunks) == 3_981_312_000 + \
        2 * 8 * chunks * 48 * 48 == 4_074_651_648
    assert k3_bytes(4, 16, d, chunks) == 4 * 4_074_651_648
