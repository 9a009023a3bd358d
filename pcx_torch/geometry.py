"""Geometry: material 'flag' predicates and the edge-DoF and cell-centre
masks on the staggered grid.

A numpy copy of ``pcx/geometry.py`` (the port never imports ``pcx``): the
flag predicates, ``edge_mask`` and ``volume_mask`` with their on-disk
cache, the reference-layout index conversions and
``volume_adjacent_edge_masks``.  The material region is a boolean
(3, N, N, N) mask, one bool per Yee edge DoF, axis order (component, i, j,
k), and a boolean (N, N, N) mask of cell centres for the off-diagonal
entries of a tensor dielectric.  The masks are built by the C++ engine
(``pcx_torch.native``, ``use_native=True``, the default) or with numpy
(``use_native=False``), bit for bit the same, and cached as bit-packed npz
files under ``CACHE_DIR`` (``$PCX_GEOMETRY_CACHE``, default
``data/geometry_cache/`` of the checkout), in the JAX package's format.

Flag predicates re-derive the geometric definitions of
paper_2/dielectric.py:157-261 on broadcast coordinate grids.
"""

from __future__ import annotations

import os
import zipfile
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from pcx_torch import lattices

_PI = np.pi

# Cache directory for computed masks (npz, bit-packed), shared with pcx.
CACHE_DIR = os.environ.get(
    "PCX_GEOMETRY_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "data", "geometry_cache"),
)


def _axis_coords(n: int, half: bool) -> np.ndarray:
    """(arange(n) + 0.5*half) / n."""
    c = np.arange(n, dtype=np.float64)
    if half:
        c = c + 0.5
    return c / n


def edge_coords(n: int, component: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Broadcastable (x, y, z) coordinates of edge DoFs for one component.

    Component c has a +1/2 offset along axis c (Yee grid,
    reference: dielectric.py:104-117).  Shapes: (n,1,1), (1,n,1), (1,1,n).
    """
    x = _axis_coords(n, component == 0).reshape(n, 1, 1)
    y = _axis_coords(n, component == 1).reshape(1, n, 1)
    z = _axis_coords(n, component == 2).reshape(1, 1, n)
    return x, y, z


def volume_coords(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cell-center coordinates, +1/2 offset on all axes
    (reference: dielectric.py:119-130)."""
    x = _axis_coords(n, True).reshape(n, 1, 1)
    y = _axis_coords(n, True).reshape(1, n, 1)
    z = _axis_coords(n, True).reshape(1, 1, n)
    return x, y, z


def _transform(coords, ct_inv_t: np.ndarray):
    """Apply the row-vector transform  r' = r @ inv(CT^T)
    (reference: dielectric.py:86)."""
    x, y, z = coords
    m = ct_inv_t
    tx = x * m[0, 0] + y * m[1, 0] + z * m[2, 0]
    ty = x * m[0, 1] + y * m[1, 1] + z * m[2, 1]
    tz = x * m[0, 2] + y * m[1, 2] + z * m[2, 2]
    return tx, ty, tz


def flag_sc_flat1(x, y, z):
    """Three orthogonal flat bars of square cross-section 0.25
    (reference: dielectric.py:157-162)."""
    return (((x <= 0.25) & (y <= 0.25))
            | ((x <= 0.25) & (z <= 0.25))
            | ((y <= 0.25) & (z <= 0.25)))


def flag_sc_flat2(x, y, z):
    """Staggered flat-bar network (reference: dielectric.py:164-170)."""
    return (((x <= 0.25) & (y <= 0.25))
            | ((x <= 0.25) & (z >= 0.25) & (z <= 0.5))
            | ((y >= 0.5) & (y <= 0.75) & (z >= 0.5) & (z <= 0.75))
            | ((x >= 0.5) & (x <= 0.75) & (z >= 0.75)))


def flag_sc_curv(x, y, z):
    """Central sphere R=0.345 plus three axis cylinders r=0.11
    (reference: dielectric.py:173-181)."""
    r1, big_r1 = 0.11, 0.345
    cx, cy, cz = x - 0.5, y - 0.5, z - 0.5
    x2, y2, z2 = cx * cx, cy * cy, cz * cz
    return ((x2 + y2 + z2 <= big_r1**2)
            | (x2 + y2 <= r1**2)
            | (x2 + z2 <= r1**2)
            | (y2 + z2 <= r1**2))


def _gyroid(x, y, z):
    return (np.sin(2 * _PI * x) * np.cos(2 * _PI * y)
            + np.sin(2 * _PI * y) * np.cos(2 * _PI * z)
            + np.sin(2 * _PI * z) * np.cos(2 * _PI * x))


def flag_bcc_sg(x, y, z):
    """Single gyroid, level set g > 1.1 (reference: dielectric.py:186-199)."""
    return _gyroid(x, y, z) > 1.1


def flag_bcc_dg(x, y, z):
    """Double gyroid, |g| > 1.1 (reference: dielectric.py:186-199)."""
    return np.abs(_gyroid(x, y, z)) > 1.1


def flag_fcc(x, y, z):
    """FCC network: 18 spheres (r=0.12) + 16 ellipsoidal connectors
    (reference: dielectric.py:201-261)."""
    r = 0.12
    b_val = 0.11

    # fcc basis points (columns of `a` in the reference) and cell center.
    basis = np.array([[0, 0, 0.5, 0.5],
                      [0, 0.5, 0, 0.5],
                      [0, 0.5, 0.5, 0]], dtype=np.float64)
    cnt = np.full(3, 0.25)

    # 14 corner/face points + the 4 points cnt + basis  -> 18 sphere centers.
    corners = np.array([
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 1], [1, 0, 1],
        [1, 1, 0], [1, 1, 1], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0],
        [1, 0.5, 0.5], [0.5, 1, 0.5], [0.5, 0.5, 1],
    ], dtype=np.float64).T
    centers = np.hstack((corners, cnt[:, None] + basis))  # (3, 18)

    shape = np.broadcast_shapes(np.shape(x), np.shape(y), np.shape(z))
    mask = np.zeros(shape, dtype=bool)
    for ctr in centers.T:
        d2 = (x - ctr[0]) ** 2 + (y - ctr[1]) ** 2 + (z - ctr[2]) ** 2
        mask |= d2 < r * r

    # 4 ellipsoid directions: from cell center cnt to each basis point,
    # replicated at the 4 basis translations -> 16 ellipsoids.
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
            mask |= (l1 / a_val**2 + l2 / b_val**2) < 1
    return mask


FLAG_REGISTRY: Dict[str, Callable] = {
    "sc_flat1": flag_sc_flat1,
    "sc_flat2": flag_sc_flat2,
    "sc_curv": flag_sc_curv,
    "bcc_sg": flag_bcc_sg,
    "bcc_dg": flag_bcc_dg,
    "fcc": flag_fcc,
}


def _cache_path(lattice: str, n: int, dofs: str) -> str:
    return os.path.join(CACHE_DIR, f"{lattice}_{n}_{dofs}.npz")


def _load_mask(path: str, shape) -> Optional[np.ndarray]:
    """The cached mask at ``path``, or None when there is none or it cannot
    be read (a file another process is still writing: rebuilt)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as f:
            bits = np.unpackbits(f["bits"])
        return bits[: int(np.prod(shape))].reshape(shape).astype(bool)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _save_mask(path: str, mask: np.ndarray) -> None:
    """Write the bit-packed mask through a temporary file and a rename, so
    that a reader never sees half a file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path[:-len('.npz')]}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, bits=np.packbits(mask.reshape(-1)))
    os.replace(tmp, path)


def edge_mask(n: int, lattice: Optional[str], cache: bool = True,
              rng: Optional[np.random.Generator] = None,
              use_native: bool = True) -> np.ndarray:
    """Boolean (3, N, N, N) mask of material edge DoFs, read from and
    written to the cache unless ``cache=False``; built by the C++ engine
    (a failed build raises) or, with ``use_native=False``, by numpy.

    ``lattice=None`` produces the reference's random fake (~37.2% fill,
    dielectric.py:74-77) for flag-less smoke runs.
    """
    if lattice is None:
        rng = rng or np.random.default_rng(0)
        return rng.random((3, n, n, n)) < 0.372
    path = _cache_path(lattice, n, "edge")
    mask = _load_mask(path, (3, n, n, n)) if cache else None
    if mask is not None:
        return mask
    ct_inv_t = np.linalg.inv(lattices.ct_matrix(lattice).T)
    if use_native:
        from pcx_torch import native
        mask = native.edge_mask(n, lattice, ct_inv_t)
    else:
        flag = FLAG_REGISTRY[lattice]
        mask = np.empty((3, n, n, n), dtype=bool)
        for c in range(3):
            mask[c] = flag(*_transform(edge_coords(n, c), ct_inv_t))
    if cache:
        _save_mask(path, mask)
    return mask


def volume_mask(n: int, lattice: Optional[str], cache: bool = True,
                rng: Optional[np.random.Generator] = None,
                use_native: bool = True) -> np.ndarray:
    """Boolean (N, N, N) mask of material cell centers (``lattice=None``:
    the random fake, as ``edge_mask``; ``cache`` and ``use_native`` as
    there)."""
    if lattice is None:
        rng = rng or np.random.default_rng(1)
        return rng.random((n, n, n)) < 0.372
    path = _cache_path(lattice, n, "volume")
    mask = _load_mask(path, (n, n, n)) if cache else None
    if mask is not None:
        return mask
    ct_inv_t = np.linalg.inv(lattices.ct_matrix(lattice).T)
    if use_native:
        from pcx_torch import native
        mask = native.volume_mask(n, lattice, ct_inv_t)
    else:
        mask = FLAG_REGISTRY[lattice](*_transform(volume_coords(n), ct_inv_t))
        mask = np.broadcast_to(mask, (n, n, n)).copy()
    if cache:
        _save_mask(path, mask)
    return mask


# ---------------------------------------------------------------------------
# Reference-format interop (flat int64 indices, i fastest).
# ---------------------------------------------------------------------------

def mask_to_indices(mask: np.ndarray) -> np.ndarray:
    """Convert a mask to sorted flat indices in the reference layout
    (flat = i + j*N + k*N^2 [+ c*N^3]), for fixture parity tests."""
    if mask.ndim == 4:           # (3, i, j, k) -> flat (c, k, j, i)
        flat = mask.transpose(0, 3, 2, 1).reshape(-1)
    else:                        # (i, j, k) -> flat (k, j, i)
        flat = mask.transpose(2, 1, 0).reshape(-1)
    return np.flatnonzero(flat).astype(np.int64)


def indices_to_mask(ind: np.ndarray, n: int, dofs: str = "edge") -> np.ndarray:
    """Inverse of :func:`mask_to_indices` (reads reference .bin caches)."""
    if dofs == "edge":
        flat = np.zeros(3 * n**3, dtype=bool)
        flat[ind] = True
        return flat.reshape(3, n, n, n).transpose(0, 3, 2, 1)
    flat = np.zeros(n**3, dtype=bool)
    flat[ind] = True
    return flat.reshape(n, n, n).transpose(2, 1, 0)


def volume_adjacent_edge_masks(n: int, lattice: Optional[str]) -> np.ndarray:
    """Per-component (3, N, N, N) masks of edge DoFs adjacent to material
    volume cells: an edge DoF is marked when any of the 4 cells around it
    is material (the mask form of mesh3d_offdiagonal_dofs,
    paper_2/dielectric.py:132-150), by rolls of the volume mask along the
    two axes orthogonal to the component."""
    vm = volume_mask(n, lattice)
    out = np.zeros((3, n, n, n), dtype=bool)
    axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    for c in range(3):
        a1, a2 = axes[c]
        for s1 in (0, 1):
            for s2 in (0, 1):
                out[c] |= np.roll(np.roll(vm, s1, axis=a1), s2, axis=a2)
    return out
