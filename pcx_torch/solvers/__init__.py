"""Eigensolvers: the production soft-locking LOBPCG, the complex LOBPCG
family, Davidson / Jacobi-Davidson and their dense algebra."""
from pcx_torch.solvers import rayleigh_ritz, lobpcg
from pcx_torch.solvers.lobpcg import (
    lobpcg_sep,
    lobpcg_sep_lanes,
    lobpcg_sep_softlock,
    lobpcg_sep_nolock,
    lobpcg_default,
    SolveResult,
    Status,
)
