"""Validation: eigenvalue recompute, spurious-mode gate, frequencies.

Port of ``pcx/validate.py`` (``recompute``, ``ValidationReport``,
``SpuriousModeError``, ``print_standard_deviation``, ``observed_order``).
The core invariant: eigenvalues of the *penalized*
operator, recomputed as Rayleigh quotients of the *unpenalized* A M A^H,
must agree; otherwise the eigenvector has a divergence component (a
spurious mode) and the run is invalid
(reference: recompute_normalize_print, numerical_experiments.py:87-158).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pcx_torch.config import SCAL
from pcx_torch.utils import RED, RESET, dots, norms, sqrt_robust


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


def recompute(lambdas_in, x: Optional[torch.Tensor] = None, a_apply=None,
              shift: float = 0.0, scal: float = SCAL,
              spurious_tol: float = 1e-3, raise_on_spurious: bool = True,
              verbose: bool = False, stats=None) -> ValidationReport:
    """Recompute eigenvalues against the unpenalized operator and convert
    both to frequencies omega = sqrt(lambda) * scal / (2 pi).

    Either pass ``(x, a_apply)``, the Ritz block (nev, ...) and the
    unpenalized operator, whose Rayleigh quotients and residual norms
    against ``lambdas_in`` (shift removed) are computed here in the block's
    dtype, or ``stats = (lam_re, residuals)`` computed elsewhere (the
    solver's refine) (reference: recompute_normalize_print,
    numerical_experiments.py:87-158).
    """
    lambdas = np.asarray(lambdas_in, dtype=float)
    if shift > 0.0:
        lambdas = lambdas - shift
    if stats is not None:
        lam_re = np.asarray(stats[0], dtype=float)[: lambdas.shape[0]]
        res = np.asarray(stats[1], dtype=float)[: lambdas.shape[0]]
    else:
        adax = a_apply(x)
        lam_re = (dots(x, adax) / dots(x, x)).real.cpu().numpy()
        lam = torch.as_tensor(lambdas, device=x.device).to(x.dtype)
        r = adax - lam.reshape((-1,) + (1,) * (x.dim() - 1)) * x
        res = norms(r).cpu().numpy()

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


def print_standard_deviation(omega_pnt: np.ndarray, omega_re: np.ndarray,
                             nev: Optional[int] = None):
    """Std-dev table across repeated runs
    (reference: numerical_experiments.py:179-187)."""
    sd_pnt = np.std(np.asarray(omega_pnt), axis=0)
    sd_re = np.std(np.asarray(omega_re), axis=0)
    nev = nev or len(sd_pnt)
    print("\nStandard deviation of each eigenvalue:")
    print("| i  |  std_pnt  |  std_re   |")
    for i in range(nev):
        print(f"| {i + 1:<2d} | {sd_pnt[i]:<6.3e} | {sd_re[i]:<6.3e} |")
    return sd_pnt, sd_re


def observed_order(freqs_by_n: dict, verbose: bool = True) -> np.ndarray:
    """Observed convergence order from a grid-refinement study
    {N: omega array}, Ns doubling: order = log2(|d1| / |d2|)
    (reference: paper_2_test.py:363-401 precision_test)."""
    ns = sorted(freqs_by_n)
    if len(ns) < 3:
        raise ValueError("Need at least 3 grid sizes.")
    orders = []
    for i in range(len(ns) - 2):
        f0, f1, f2 = (np.asarray(freqs_by_n[ns[i + j]]) for j in range(3))
        d1 = np.abs(f1 - f0)
        d2 = np.abs(f2 - f1)
        orders.append(np.log2(np.maximum(d1, 1e-300) / np.maximum(d2, 1e-300)))
    orders = np.array(orders)
    if verbose:
        for i, row in enumerate(orders):
            print(f"N={ns[i]}->{ns[i + 2]}: orders {np.round(row, 2)}")
    return orders
