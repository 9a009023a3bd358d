"""Lattice data of the benchmark: coordinate transforms and Brillouin-zone
paths, a frozen copy of the upstream definitions (paper_2/environment.py:
72-82, dielectric.py:20-49, numerical_experiments.py:342-346), so that the
traffic and the reference depend on no file of the program."""

from __future__ import annotations

import numpy as np

_PI = np.pi

CT = {
    "sc": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
    "bcc": np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]], dtype=float),
    "fcc": np.array([[-1, 1, 1], [1, -1, 1], [1, 1, -1]], dtype=float),
}

SYM = {
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
    return lattice.split("_")[0]


def ct_matrix(lattice: str) -> np.ndarray:
    return CT[family(lattice)].copy()


def k_path(lattice: str, gap: int) -> np.ndarray:
    """The discrete path, (segments * gap, 3): segment i runs from sym[i]
    (exclusive) to sym[i + 1] (inclusive, at index (i + 1) gap - 1)."""
    sym = SYM[family(lattice)]
    out = np.zeros(((sym.shape[0] - 1) * gap, 3))
    for i in range(sym.shape[0] - 1):
        for j in range(gap - 1):
            out[i * gap + j] = ((j + 1) * sym[i + 1] + (gap - j - 1) * sym[i]
                                ) / gap
        out[(i + 1) * gap - 1] = sym[i + 1]
    return out


def set_relaxation(alpha, scal: float = 1.0):
    """((shift, relaxation), penalty weight) of a wave vector
    (paper_2/discretization.py:31-49)."""
    nrm = float(np.linalg.norm(np.asarray(alpha, float) / scal))
    if nrm > 1:
        return (0.0, 0.6), 4 * _PI * _PI
    if nrm == 0:
        return (1.0 / _PI, 0.6), 4 * _PI * _PI
    return (nrm, 0.6), (2 * _PI / nrm) ** 2
