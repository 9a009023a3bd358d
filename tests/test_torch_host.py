"""The port's numpy host modules against the JAX package's: geometry masks,
BZ paths, stencil symbols, relaxation and block width.  Exact equality: the
port carries copies of the same host code."""

import numpy as np
import pytest

from pcx import config as jcfg
from pcx import geometry as jgeo
from pcx import lattices as jlat
from pcx import stencils as jst
from pcx import utils as jutils
from pcx_torch import config as tcfg
from pcx_torch import geometry as tgeo
from pcx_torch import lattices as tlat
from pcx_torch import stencils as tst
from pcx_torch import utils as tutils


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("lattice", jcfg.ALL_LATTICES)
def test_edge_mask_matches_pcx(lattice, n):
    want = jgeo.edge_mask(n, lattice, cache=False, use_native=False)
    got = tgeo.edge_mask(n, lattice, cache=False)
    assert got.dtype == bool and got.shape == (3, n, n, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lattice", ["sc_curv", "bcc_sg", "fcc"])
def test_k_path_and_ct_match_pcx(lattice):
    np.testing.assert_array_equal(tlat.k_path(lattice), jlat.k_path(lattice))
    np.testing.assert_array_equal(tlat.k_path(lattice, gap=5),
                                  jlat.k_path(lattice, gap=5))
    np.testing.assert_array_equal(tlat.ct_matrix(lattice),
                                  jlat.ct_matrix(lattice))
    np.testing.assert_array_equal(tlat.sym_points(lattice),
                                  jlat.sym_points(lattice))


@pytest.mark.parametrize("n,k,d", [(8, 1, 0), (8, 1, 1), (12, 2, 1),
                                   (120, 1, 1), (120, 1, 0)])
def test_symbol_1d_matches_pcx(n, k, d):
    np.testing.assert_array_equal(tst.symbol_1d(n, k, d, 1.0 / n),
                                  jst.symbol_1d(n, k, d, 1.0 / n))


@pytest.mark.parametrize("alpha", [(0.0, 0.0, 0.0), (np.pi, 0.0, 0.0),
                                   (0.3, 0.2, 0.1), (np.pi, np.pi, np.pi)])
def test_set_relaxation_and_block_width_match_pcx(alpha):
    got, want = tcfg.set_relaxation(alpha), jcfg.set_relaxation(alpha)
    assert got == want
    (_, rlx), _ = got
    for nev in (4, 10):
        assert tcfg.block_width(nev, rlx) == jcfg.block_width(nev, rlx)
    assert tcfg.block_width(10) == 16


@pytest.mark.parametrize("name", ["RED", "GREEN", "YELLOW", "BLUE", "MAGENTA",
                                  "CYAN", "WHITE", "RESET"])
def test_colour_constants_match_pcx(name):
    assert getattr(tutils, name) == getattr(jutils, name)
