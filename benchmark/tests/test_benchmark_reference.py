"""The plain reference against the program's complex128 solve on the CPU:
the same masks and path, and the reference's Rayleigh-Ritz of the
program's block gives back the program's own complex128-refined
frequencies."""

import numpy as np
import pytest
import torch

from benchmark import lattices
from benchmark.reference import geometry, maxwell

CONFIGS = [("fcc", "chiral"), ("sc_curv", "pseudochiral_crossdof")]


@pytest.mark.parametrize("lattice", sorted(geometry.FLAGS))
def test_masks_and_path_match_the_upstream_definitions(lattice):
    from pcx_torch import geometry as pg, lattices as pl
    ref = geometry.edge_mask(10, lattice, cache=False)
    assert np.array_equal(ref, pg.edge_mask(10, lattice, cache=False,
                                            use_native=False))
    assert np.array_equal(lattices.k_path(lattice, 20), pl.k_path(lattice))


@pytest.mark.parametrize("lattice,diel", CONFIGS)
def test_operator_matches_the_program_on_a_random_block(lattice, diel):
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.operators import maxwell as pm
    n = 8
    cfg = {"n": n, "lattice": lattice, "diel_type": diel, "eps_opt": 0,
           "nev": 4}
    s = KPointSolver(ProblemConfig(n=n, lattice=lattice, diel_type=diel,
                                   nev=4), device="cpu")
    alpha = lattices.k_path(lattice, 20)[13]
    x = torch.randn((3, 3, n, n, n), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(0))
    sy = s.symbols_for(alpha)
    want = pm.ama_bb(x, sy.d_a, sy.b, s.diel, sy.shift)
    op = maxwell.Operator(cfg, maxwell.Dielectric(cfg, "cpu", cache=False),
                          alpha, "cpu")
    got = op.h(x)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("lattice,diel", CONFIGS)
def test_judge_reproduces_the_complex128_refine(lattice, diel):
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    n, nev = 10, 6
    cfg = {"n": n, "lattice": lattice, "diel_type": diel, "eps_opt": 0,
           "nev": nev}
    s = KPointSolver(ProblemConfig(n=n, lattice=lattice, diel_type=diel,
                                   nev=nev), device="cpu",
                     dtype=torch.complex128)
    alpha = lattices.k_path(lattice, 20)[12]
    r = s.solve(alpha, seed=3)
    op = maxwell.Operator(cfg, maxwell.Dielectric(cfg, "cpu", cache=False),
                          alpha, "cpu")
    got = maxwell.judge(cfg, op, r.x, r.omega, r.omega_re)
    assert got.omega_gap < 1e-10
    assert got.spurious_gap < 1e-10
    assert got.freq_bound < 1e-4
    # a frequency moved by 1e-4 reads as that gap
    moved = np.array(r.omega_re)
    moved[2] += 1e-4
    assert maxwell.judge(cfg, op, r.x, r.omega, moved).omega_gap == \
        pytest.approx(1e-4, rel=1e-3)


def test_a_rank_deficient_block_reads_inf():
    cfg = {"n": 6, "lattice": "sc_curv", "diel_type": "chiral",
           "eps_opt": 0, "nev": 2}
    op = maxwell.Operator(cfg, maxwell.Dielectric(cfg, "cpu", cache=False),
                          [np.pi, 0, 0], "cpu")
    x = torch.zeros((4, 3, 6, 6, 6), dtype=torch.complex128)
    got = maxwell.judge(cfg, op, x, np.zeros(2), np.zeros(2))
    assert got == maxwell.Readings(np.inf, np.inf, np.inf)
