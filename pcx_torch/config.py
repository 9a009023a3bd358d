"""Configuration: global defaults, precision policy, problem/solver configs.

A numpy-only copy of ``pcx/config.py``: the port never imports ``pcx``,
whose package import loads JAX.  Reference: paper_2/environment.py:23-55,
numerical_experiments.py:498-513.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Global defaults (reference: paper_2/environment.py:23-32).
# ---------------------------------------------------------------------------

K = 1          # Stencil half-width (accuracy order 2K).
NEV = 10       # Number of desired eigenpairs.
SCAL = 1.0     # Lattice scaling constant.
TOL = 1e-4     # LOBPCG residual tolerance.
GAP = 20       # Points per Brillouin-zone path segment.

MAXITER = 500
N_SUBSPACE = 40   # Davidson/JD subspace capacity (solvers/davidson.py).

# Lattice type names (reference: paper_2/environment.py:35-40).
SC_F1 = "sc_flat1"
SC_F2 = "sc_flat2"
SC_C = "sc_curv"
BCC_SG = "bcc_sg"
BCC_DG = "bcc_dg"
FCC = "fcc"

ALL_LATTICES = (SC_F1, SC_F2, SC_C, BCC_SG, BCC_DG, FCC)

# Dielectric ("chiroptical") types (reference: paper_2/environment.py:43-46).
TYPE_CHIRAL = "chiral"
TYPE_PSEUDO_TRIVIAL = "pseudochiral_trivial"
TYPE_PSEUDO_CROSSDOF = "pseudochiral_crossdof"
TYPE_PSEUDO_CROSSDOF2 = "pseudochiral_crossdof2"

# Isotropic dielectric constants per lattice
# (reference: paper_2/environment.py:49).
CHIRAL_EPS_EG = {
    SC_F1: 13.0,
    SC_F2: 13.0,
    SC_C: 13.0,
    BCC_SG: 16.0,
    BCC_DG: 16.0,
    FCC: 13.0,
}

# Hermitian positive-definite 3x3 tensors stored as 6 components
# (d11, d22, d33, d12, d13, d23) (reference: paper_2/environment.py:52-55).
PSEUDOCHIRAL_EPS_LOC = [
    np.array([(1 + 0.875**2) ** 0.5, (1 + 0.875**2) ** 0.5, 1.0,
              -1j * 0.875, 0.0, 0.0]),
    np.array([(1 + 0.875**2) ** 0.5, 1.0, (1 + 0.875**2) ** 0.5,
              0.0, 1j * 0.875, 0.0]),
    np.array([1.0346, 0.5059, 0.2595,
              -0.0163 - 0.2319j, 0.027 + 0.0827j, -0.2743 - 0.0076j]),
    np.array([3.0, 3.0, 3.0,
              np.sqrt(3) + 1j, 1j, np.sqrt(2) * (1 + 1j)]) / 5.0,
]


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """One Maxwell eigenproblem instance."""

    n: int                                   # Grid size N (DoFs = 3N^3).
    lattice: str = SC_C                      # Lattice flag name.
    diel_type: str = TYPE_CHIRAL             # Dielectric operator type.
    eps_opt: int = 0                         # Pseudochiral preset index; for
                                             # chiral the eps (0: lattice's).
    k: int = K                               # Stencil half-width.
    scal: float = SCAL                       # Lattice scaling constant.
    nev: int = NEV

    def __post_init__(self):
        if self.lattice is not None and self.lattice not in ALL_LATTICES:
            raise ValueError(f"Unknown lattice {self.lattice!r}; "
                             f"expected one of {ALL_LATTICES}.")


def set_relaxation(alpha: Sequence[float], scal: float = SCAL):
    """Spectral shift, block-relaxation ratio, and penalty gamma.

    Reference: paper_2/discretization.py:31-49.  Returns ((shift, rlx), pnt).
    The shift guarantees non-singularity at the Gamma point; the penalty
    gamma ("pnt") weights the divergence penalty B'B.
    """
    nrm_alpha = float(np.linalg.norm(np.asarray(alpha) / scal))
    if nrm_alpha > 1:
        opt = (0.0, 0.6)
        pnt = 4 * np.pi * np.pi
    elif nrm_alpha == 0:
        opt = (1.0 / np.pi, 0.6)
        pnt = 4 * np.pi * np.pi
    else:
        opt = (nrm_alpha, 0.6)
        pnt = (2 * np.pi / nrm_alpha) ** 2
    return opt, pnt


def block_width(nev: int, rlx: float = 0.6) -> int:
    """LOBPCG block width m = nev + round(rlx * nev)
    (reference: numerical_experiments.py:64)."""
    return nev + round(nev * rlx)
