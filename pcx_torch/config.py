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

# Lattice type names (reference: paper_2/environment.py:35-40).
SC_F1 = "sc_flat1"
SC_F2 = "sc_flat2"
SC_C = "sc_curv"
BCC_SG = "bcc_sg"
BCC_DG = "bcc_dg"
FCC = "fcc"

ALL_LATTICES = (SC_F1, SC_F2, SC_C, BCC_SG, BCC_DG, FCC)

# The dielectric type this port carries (reference: paper_2/environment.py:43).
TYPE_CHIRAL = "chiral"

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


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """One Maxwell eigenproblem instance."""

    n: int                                   # Grid size N (DoFs = 3N^3).
    lattice: str = SC_C                      # Lattice flag name.
    diel_type: str = TYPE_CHIRAL             # Dielectric operator type.
    eps_opt: int = 0                         # Chiral eps override (0: lattice's).
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
