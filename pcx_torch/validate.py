"""Validation: eigenvalue recompute, spurious-mode gate, frequencies.

Port of ``pcx/validate.py`` (``recompute``, ``ValidationReport``,
``SpuriousModeError``).  The core invariant: eigenvalues of the *penalized*
operator, recomputed as Rayleigh quotients of the *unpenalized* A M A^H,
must agree; otherwise the eigenvector has a divergence component (a
spurious mode) and the run is invalid
(reference: recompute_normalize_print, numerical_experiments.py:87-158).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pcx_torch.config import SCAL
from pcx_torch.utils import RED, RESET, sqrt_robust


class SpuriousModeError(RuntimeError):
    """Raised when penalized and recomputed frequencies deviate > 1e-3
    (reference: numerical_experiments.py:152-156)."""


@dataclasses.dataclass
class ValidationReport:
    omega_pnt: np.ndarray      # frequencies from penalized eigenvalues
    omega_re: np.ndarray       # recomputed (unpenalized Rayleigh quotient)
    residuals: np.ndarray      # per-mode residual norms of A M A^H
    spurious: bool

    def table(self) -> str:
        lines = ["| i  |    omega   |  omega_re  | |omega-omega_re| | residual  |"]
        for i, (l1, l2, r) in enumerate(
                zip(self.omega_pnt, self.omega_re, self.residuals)):
            lines.append(f"| {i + 1:<2d} | {l1:<10.6f} | {l2:<10.6f} "
                         f"|    {abs(l1 - l2):<10.3e}    | {r:<6.3e} |")
        return "\n".join(lines)


def recompute(lambdas_in, stats, shift: float = 0.0, scal: float = SCAL,
              spurious_tol: float = 1e-3, raise_on_spurious: bool = True,
              verbose: bool = False) -> ValidationReport:
    """Compare penalized eigenvalues with ``stats = (lam_re, residuals)``,
    the Rayleigh quotients and residual norms of the unpenalized operator
    (computed by the refine), and convert both to frequencies
    omega = sqrt(lambda) * scal / (2 pi).
    """
    lambdas = np.asarray(lambdas_in, dtype=float)
    if shift > 0.0:
        lambdas = lambdas - shift
    lam_re = np.asarray(stats[0], dtype=float)[: lambdas.shape[0]]
    res = np.asarray(stats[1], dtype=float)[: lambdas.shape[0]]

    # NaN cross-checks (reference: numerical_experiments.py:113-132).
    nan_pnt = np.isnan(lambdas)
    nan_re = np.isnan(lam_re)
    lam_re = np.where(nan_re & ~nan_pnt, lambdas, lam_re)

    omega_pnt = np.array([sqrt_robust(v) * scal / (2 * np.pi) for v in lambdas])
    omega_re = np.array([sqrt_robust(v) * scal / (2 * np.pi) for v in lam_re])

    # Absolute deviation; non-finite frequencies are spurious by definition
    # (NaN compares False against any tolerance), as in pcx/validate.py:81-92.
    spurious = bool(np.any(np.abs(omega_pnt - omega_re) > spurious_tol)
                    | np.any(~np.isfinite(omega_pnt))
                    | np.any(~np.isfinite(omega_re)))
    report = ValidationReport(omega_pnt, omega_re, res, spurious)
    if verbose:
        print(report.table())
    if spurious and raise_on_spurious:
        raise SpuriousModeError(f"{RED}Spurious eigenvalues occur.{RESET}")
    return report
