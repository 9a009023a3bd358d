"""The sweep logic that the window drives around ``KPointSolver.solve``:
the benchmark's copies of the production sweep's acceptance gate, its
escalation from the light refine to the complex128 refine, the one cold
retry of a rejected warm point (``pcx_torch.bandstructure.bandgap``) and
the entry block of a warm chain (``pcx_torch.bench.warm_up``).  Copied so
that a later change to the program is measured by them, not folded into
them; they reach the program only through its public calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

ACCEPTED = ("CONVERGED", "FLOOR")
MAXITER = "MAXITER"
BOUND_TOL = 2e-3        # frequency-error bound of the production gate


class Rejected(RuntimeError):
    """A solve the production gate does not accept."""


@dataclasses.dataclass
class PointRecord:
    """One k-point of the window: what the gate decided and what it cost."""
    index: int
    alpha: Optional[np.ndarray] = None
    iterations: int = 0       # LOBPCG iterations, a retry's included
    escalated: bool = False   # re-validated by the complex128 refine
    retried: bool = False     # solved again cold after a rejection
    ok: bool = False
    why: str = ""
    omega: Optional[np.ndarray] = None
    omega_re: Optional[np.ndarray] = None
    x: Optional[torch.Tensor] = None   # the Ritz block, kept for the check


def status_name(result) -> str:
    from pcx_torch.solvers.lobpcg import Status
    return Status(result.status).name


def accept(result, status: str, scal: float) -> None:
    """Raise ``Rejected`` unless the production gate accepts the solve:
    CONVERGED or FLOOR (or MAXITER with a validation that is not
    spurious), not spurious, and every band's frequency-error bound
    res * scal^2 / (8 pi^2 omega) within 2e-3."""
    rep = result.report
    ok = status in ACCEPTED or (status == MAXITER and rep is not None
                                and not rep.spurious)
    if not ok:
        raise Rejected(f"solver status {status}")
    if rep is not None and rep.spurious:
        raise Rejected("spurious eigenvalues")
    if rep is not None and rep.residuals is not None:
        om = np.maximum(np.asarray(rep.omega_re, float), 0.05)
        bound = (np.asarray(rep.residuals, float)[: len(om)] * scal ** 2
                 / (8.0 * np.pi ** 2 * om))
        if float(np.max(bound)) > BOUND_TOL:
            raise Rejected(f"under-converged: bound {np.max(bound):.2e}")


def f64_report(solver, alpha, x):
    """The complex128 refine's validation report of a block."""
    from pcx_torch import validate
    from pcx_torch.config import set_relaxation
    theta, lam_re, res = solver.refine_stats(alpha, x)
    (shift, _), _ = set_relaxation(alpha)
    shift /= solver.cfg.scal ** 2
    return validate.recompute(theta[:solver.cfg.nev], shift=shift,
                              scal=solver.cfg.scal, stats=(lam_re, res),
                              raise_on_spurious=False)


def accept_or_escalate(solver, alpha, result, rec: PointRecord):
    """``accept``; a light-refine rejection on the spurious gate or the
    bound is re-validated by the complex128 refine before it counts.
    Returns the result to keep; raises ``Rejected``."""
    status = status_name(result)
    try:
        accept(result, status, solver.cfg.scal)
        return result
    except Rejected as e:
        msg = str(e)
        if solver.refine != "light" or not ("under-converged" in msg
                                            or "spurious" in msg):
            raise
    rec.escalated = True
    report = f64_report(solver, alpha, result.x)
    r2 = dataclasses.replace(result, report=report, omega=report.omega_pnt,
                             omega_re=report.omega_re)
    accept(r2, status, solver.cfg.scal)
    return r2


def _device_error(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "CUDA" in str(e)


def solve_point(solver, point, carry: list, retry: bool) -> tuple:
    """Solve one k-point as the production sweep does: validate, gate,
    escalate; a rejected warm solve gets one cold retry when ``retry``.
    ``carry`` holds the warm start (empty: cold) and is emptied, so that
    the warm block is freed before a retry.  Returns (PointRecord, the
    kept result or None)."""
    from benchmark.traffic import RETRY_SALT
    rec = PointRecord(point.index, point.alpha)
    x0 = carry.pop() if carry else None
    attempts = 2 if (x0 is not None and retry) else 1
    for attempt in range(attempts):
        if attempt:
            rec.retried, x0 = True, None
        try:
            result = solver.solve(point.alpha, x0=x0,
                                  seed=point.seed + attempt * RETRY_SALT,
                                  raise_on_spurious=False)
            rec.iterations += int(result.iterations)
            result = accept_or_escalate(solver, point.alpha, result, rec)
        except Exception as e:  # noqa: BLE001  the sweep records any fault
            if _device_error(e):
                raise
            rec.why += f"{'; cold retry: ' if attempt else ''}{e}"
            result = None
            continue
        rec.ok = True
        rec.omega, rec.omega_re = result.omega, result.omega_re
        return rec, result
    return rec, None


def entry_block(solver, point, settle_passes: int, settle_iters: int):
    """The untimed entry of a warm chain: a cold solve at ``point``, then
    up to ``settle_passes`` warm re-solves from its own block, each kept
    while accepted by status, ending once one takes at most
    ``settle_iters`` iterations.  Returns the result whose block enters
    the chain."""
    r = solver.solve(point.alpha, seed=point.seed, validate_result=False)
    for _ in range(settle_passes):
        r2 = solver.solve(point.alpha, x0=r.x, validate_result=False)
        if status_name(r2) not in ACCEPTED:
            break
        r = r2
        if r2.iterations <= settle_iters:
            break
    return r
