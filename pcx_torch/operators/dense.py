"""Dense materialization and structural checks of operators at small N.

Port of ``pcx/operators/dense.py``, used by the structural experiments
(dmat_cmp, check_sdd, the HPD checks; reference: paper_2/paper_2_test.py:
233-297) and by tests.  Dense forms are only feasible for small N: the
(3N^3)^2 matrix is held on the host.  The SDD census also has a
matrix-free form (``DielectricOp.sdd_violations``).
"""

from __future__ import annotations

import numpy as np
import torch


# Columns of the identity applied at once by ``materialize``.
CHUNK = 512


def materialize(op, n: int, device="cuda",
                dtype: torch.dtype = torch.complex128) -> np.ndarray:
    """(3n^3, 3n^3) dense matrix of an operator acting on (m, 3, n, n, n)
    blocks: column j is the image of basis vector j.  The identity is
    applied on ``device`` in blocks of ``CHUNK`` columns."""
    d = 3 * n ** 3
    mat = np.empty((d, d), dtype=np.complex128)
    for j0 in range(0, d, CHUNK):
        j1 = min(j0 + CHUNK, d)
        eye = torch.zeros((j1 - j0, d), dtype=dtype, device=device)
        eye[torch.arange(j1 - j0, device=device),
            torch.arange(j0, j1, device=device)] = 1.0
        cols = op(eye.reshape(j1 - j0, 3, n, n, n)).reshape(j1 - j0, d)
        mat[:, j0:j1] = cols.cpu().numpy().T
    return mat


def dense_diff_report(m1: np.ndarray, m2: np.ndarray, names=("A", "B"),
                      verbose: bool = True) -> dict:
    """Entrywise comparison of two operator matrices and the spectral
    radius of the difference (reference: dmat_cmp, paper_2_test.py:
    233-257)."""
    diff = m1 - m2
    nz = np.abs(diff[np.abs(diff) > 0])
    out = {
        "size": m1.shape[0],
        "nnz": int(nz.size),
        "fro": float(np.linalg.norm(diff)),
        "max_nz": float(nz.max()) if nz.size else 0.0,
        "min_nz": float(nz.min()) if nz.size else 0.0,
        "spectral_radius": float(np.abs(np.linalg.eigvals(diff)).max())
        if nz.size else 0.0,
    }
    if verbose:
        print(f"{names[0]} vs {names[1]}: size = {out['size']}, "
              f"nnz = {out['nnz']}, fro = {out['fro']:<6.3e}, "
              f"max_nz = {out['max_nz']:<6.3e}, "
              f"rho = {out['spectral_radius']:<6.3e}.")
    return out


def check_sdd_dense(mat: np.ndarray, verbose: bool = True) -> int:
    """Count rows violating strict diagonal dominance
    (reference: check_sdd, paper_2_test.py:259-269)."""
    diag = np.abs(np.diag(mat)).real
    offsum = np.sum(np.abs(mat), axis=1) - diag
    n_bad = int(np.sum(diag <= offsum))
    if verbose:
        print(f"SDD not satisfied n_row = {n_bad}.")
    return n_bad
