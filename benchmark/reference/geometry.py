"""Material masks of the reference: the upstream flag predicates
(paper_2/dielectric.py:157-261) evaluated with numpy at the staggered
(Yee) edge coordinates, mapped through inv(CT^T).  One boolean per edge
DoF, axis order (component, i, j, k).

Built here from the lattice's definition alone; a mask is cached, bit
packed, under ``benchmark/.cache/reference/`` of the checkout, never read
from the program's cache.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import lattices

_PI = np.pi
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".cache", "reference")


def _coords(n: int, component: int):
    """(x, y, z) of the edge DoFs of one component, broadcastable: +1/2 of
    a cell along the component's own axis."""
    c = [(np.arange(n, dtype=np.float64) + (0.5 if a == component else 0.0))
         / n for a in range(3)]
    return c[0].reshape(n, 1, 1), c[1].reshape(1, n, 1), c[2].reshape(1, 1, n)


def _transform(coords, m: np.ndarray):
    x, y, z = coords
    return (x * m[0, 0] + y * m[1, 0] + z * m[2, 0],
            x * m[0, 1] + y * m[1, 1] + z * m[2, 1],
            x * m[0, 2] + y * m[1, 2] + z * m[2, 2])


def _sc_flat1(x, y, z):
    return (((x <= 0.25) & (y <= 0.25)) | ((x <= 0.25) & (z <= 0.25))
            | ((y <= 0.25) & (z <= 0.25)))


def _sc_flat2(x, y, z):
    return (((x <= 0.25) & (y <= 0.25))
            | ((x <= 0.25) & (z >= 0.25) & (z <= 0.5))
            | ((y >= 0.5) & (y <= 0.75) & (z >= 0.5) & (z <= 0.75))
            | ((x >= 0.5) & (x <= 0.75) & (z >= 0.75)))


def _sc_curv(x, y, z):
    r1, big_r1 = 0.11, 0.345
    cx, cy, cz = x - 0.5, y - 0.5, z - 0.5
    x2, y2, z2 = cx * cx, cy * cy, cz * cz
    return ((x2 + y2 + z2 <= big_r1 ** 2) | (x2 + y2 <= r1 ** 2)
            | (x2 + z2 <= r1 ** 2) | (y2 + z2 <= r1 ** 2))


def _gyroid(x, y, z):
    return (np.sin(2 * _PI * x) * np.cos(2 * _PI * y)
            + np.sin(2 * _PI * y) * np.cos(2 * _PI * z)
            + np.sin(2 * _PI * z) * np.cos(2 * _PI * x))


def _bcc_sg(x, y, z):
    return _gyroid(x, y, z) > 1.1


def _bcc_dg(x, y, z):
    return np.abs(_gyroid(x, y, z)) > 1.1


def _fcc(x, y, z):
    """18 spheres of radius 0.12 and 16 ellipsoidal connectors."""
    r, b_val = 0.12, 0.11
    basis = np.array([[0, 0, 0.5, 0.5], [0, 0.5, 0, 0.5], [0, 0.5, 0.5, 0]],
                     dtype=np.float64)
    cnt = np.full(3, 0.25)
    corners = np.array([
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 1], [1, 0, 1],
        [1, 1, 0], [1, 1, 1], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0],
        [1, 0.5, 0.5], [0.5, 1, 0.5], [0.5, 0.5, 1],
    ], dtype=np.float64).T
    centers = np.hstack((corners, cnt[:, None] + basis))
    mask = np.zeros(np.broadcast_shapes(np.shape(x), np.shape(y),
                                        np.shape(z)), dtype=bool)
    for ctr in centers.T:
        d2 = (x - ctr[0]) ** 2 + (y - ctr[1]) ** 2 + (z - ctr[2]) ** 2
        mask |= d2 < r * r
    for i in range(4):
        o = (basis[:, i] + cnt) / 2
        d = (basis[:, i] - cnt) / 2
        c_i = np.linalg.norm(d)
        d = d / c_i
        a_val = np.hypot(b_val, c_i)
        for j in range(4):
            ctr = o + basis[:, j]
            dx, dy, dz = x - ctr[0], y - ctr[1], z - ctr[2]
            l1 = (d[0] * dx + d[1] * dy + d[2] * dz) ** 2
            l2 = dx * dx + dy * dy + dz * dz - l1
            mask |= (l1 / a_val ** 2 + l2 / b_val ** 2) < 1
    return mask


FLAGS = {"sc_flat1": _sc_flat1, "sc_flat2": _sc_flat2, "sc_curv": _sc_curv,
         "bcc_sg": _bcc_sg, "bcc_dg": _bcc_dg, "fcc": _fcc}


def edge_mask(n: int, lattice: str, cache: bool = True) -> np.ndarray:
    """Boolean (3, N, N, N) mask of the material edge DoFs."""
    path = os.path.join(CACHE, f"{lattice}_{n}_edge.npy")
    shape = (3, n, n, n)
    if cache and os.path.exists(path):
        bits = np.load(path)
        return np.unpackbits(bits)[: 3 * n ** 3].reshape(shape).astype(bool)
    m = np.linalg.inv(lattices.ct_matrix(lattice).T)
    mask = np.empty(shape, dtype=bool)
    for c in range(3):
        mask[c] = FLAGS[lattice](*_transform(_coords(n, c), m))
    if cache:
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, np.packbits(mask.reshape(-1)))
        os.replace(tmp, path)
    return mask
