"""Lattice metadata: coordinate transforms, Brillouin-zone symmetry paths.

Reference: paper_2/environment.py:72-82 (DIEL_LIB), paper_2/dielectric.py:20-49
(diel_info / diel_alpha).  Here the registry is explicit (no string eval).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pcx_torch.config import GAP

_PI = np.pi

# Coordinate-transform matrices per Bravais family
# (reference: environment.py:72-74).
_CT = {
    "sc": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
    "bcc": np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]], dtype=float),
    "fcc": np.array([[-1, 1, 1], [1, -1, 1], [1, 1, -1]], dtype=float),
}

# Brillouin-zone symmetry-point paths (reference: environment.py:75-82).
_SYM = {
    "sc": np.array([
        [0, 0, 0], [_PI, 0, 0], [_PI, _PI, 0], [_PI, _PI, _PI], [0, 0, 0],
    ]),
    "bcc": np.array([
        [0, 0, 2 * _PI], [0, 0, 0], [_PI, _PI, _PI],
        [0, 0, 2 * _PI], [_PI, 0, _PI], [0, 0, 0],
        [0, 2 * _PI, 0], [_PI, _PI, _PI], [_PI, 0, _PI],
    ]),
    "fcc": np.array([
        [0, 2 * _PI, 0], [_PI / 2, 2 * _PI, _PI / 2], [_PI, _PI, _PI],
        [0, 0, 0], [0, 2 * _PI, 0], [_PI, 2 * _PI, 0],
        [3 * _PI / 2, 3 * _PI / 2, 0],
    ]),
}


def family(lattice: str) -> str:
    """Bravais family of a lattice flag, e.g. 'bcc_dg' -> 'bcc'
    (reference: dielectric.py:27)."""
    return lattice.split("_")[0]


def ct_matrix(lattice: str) -> np.ndarray:
    """Coordinate-transform matrix CT (reference: dielectric.py:20-31)."""
    return _CT[family(lattice)].copy()


def sym_points(lattice: str) -> np.ndarray:
    """Symmetry points of the BZ path (reference: dielectric.py:20-35)."""
    return _SYM[family(lattice)].copy()


def lattice_info(lattice: str) -> Tuple[np.ndarray, np.ndarray]:
    """(CT, symmetry points) pair (reference: dielectric.py:20-35)."""
    return ct_matrix(lattice), sym_points(lattice)


def k_point(lattice: str, no: int, gap: int = GAP) -> np.ndarray:
    """Interpolated wave vector at path position ``no``
    (reference: dielectric.py:37-49)."""
    sym = sym_points(lattice)
    i0, j0 = no // gap, no % gap
    if j0 == 0:
        return sym[i0, :]
    return (j0 * sym[i0 + 1, :] + (gap - j0) * sym[i0, :]) / gap


def k_path(lattice: str, gap: int = GAP) -> np.ndarray:
    """Full discrete BZ path, shape (n_segments * gap, 3).

    Matches the reference sweep layout: the i-th segment contributes points
    interpolated from sym[i] (exclusive) to sym[i+1] (inclusive)
    (reference: numerical_experiments.py:342-346).
    """
    sym = sym_points(lattice)
    n_pt = sym.shape[0] - 1
    alphas = np.zeros((n_pt * gap, 3))
    for i in range(n_pt):
        alphas[(i + 1) * gap - 1, :] = sym[i + 1, :]
        for j in range(gap - 1):
            alphas[i * gap + j, :] = (
                (j + 1) * sym[i + 1, :] + (gap - j - 1) * sym[i, :]
            ) / gap
    return alphas
