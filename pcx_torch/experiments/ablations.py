"""Parameter-ablation experiments (the Paper-1 study set).

Port of ``pcx/experiments/ablations.py`` (reference: paper_2/
paper_1_test.py:40-270, tol/pnt/rela/scal/eps/grid_cmp and the library
LOBPCG comparison).  Each runner returns a structured result and prints the
reference-style summary.  Every runner takes a ``device`` (default
``"cuda"``) and, where the JAX one takes a ``dtype``, a torch dtype
(default complex128, as there).  Random start blocks come from
``torch.Generator``s seeded as the JAX keys are (not the same bits).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pcx_torch import validate
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import (NEV, TOL, ProblemConfig, block_width,
                              set_relaxation)
from pcx_torch.operators import dielectric as diel_mod
from pcx_torch.operators import maxwell
from pcx_torch.operators import symbols as sym
from pcx_torch.operators.blocks import h_block
from pcx_torch.solvers import lobpcg as lob
from pcx_torch.utils import generator

_PI = np.pi
DEFAULT_ALPHA = np.array([_PI, _PI, _PI])


def _collect(results):
    omega = np.stack([r.omega for r in results])
    omega_re = np.stack([r.omega_re for r in results])
    iters = np.array([[r.iterations, r.wall_time] for r in results])
    return omega, omega_re, iters


def tol_cmp(n: int, lattice: str, tols: Sequence[float],
            alpha=DEFAULT_ALPHA, nev: int = NEV,
            dtype: torch.dtype = torch.complex128, verbose: bool = True,
            device="cuda"):
    """Eigenvalue invariance across solver tolerances
    (reference: paper_1_test.py:40-75)."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    results = []
    for t in tols:
        solver = KPointSolver(cfg, device=device, dtype=dtype, tol=t)
        results.append(solver.solve(alpha, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for t, it in zip(tols, iters):
            print(f"tol = {t:<5.2e}, iterations = {int(it[0])}, "
                  f"runtime = {it[1]:<5.2f}s.")
        validate.print_standard_deviation(omega, omega_re, nev)
    return {"tols": list(tols), "omega": omega, "omega_re": omega_re,
            "iters": iters}


def pnt_cmp(n: int, lattice: str, pnt_factors: Sequence[float],
            alpha=DEFAULT_ALPHA, nev: int = NEV,
            dtype: torch.dtype = torch.complex128, verbose: bool = True,
            device="cuda"):
    """Eigenvalue invariance across penalty weights gamma
    (reference: paper_1_test.py:77-107; the factors scale the default
    gamma).  Each weight runs the complex LOBPCG (``solvers.lobpcg``) on
    the solver's operator and DFT, validated by ``validate.recompute``.
    Returns [(factor, iterations, ValidationReport)]."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    base = KPointSolver(cfg, device=device, dtype=dtype)
    # The curl symbol from the solver's 1-D parts is (D_unit + i alpha D0)
    # / scal (spectrum ~ 1/scal^2), so the Gamma shift scales with it:
    # shift / scal^2, not shift_symbol's alpha-only scal argument.
    (shift, rlx), pnt0 = set_relaxation(alpha)
    shift = float(shift) / cfg.scal ** 2
    m = block_width(nev, rlx)
    d_a64 = sym.build_curl(base.parts, alpha)
    b_raw = sym.penalty_symbol(d_a64)
    d_a = d_a64.to(dtype)
    results = []
    for f in pnt_factors:
        pnt = pnt0 * f
        inv = sym.inverse_penalized_b(b_raw, pnt, shift=shift).to(dtype)
        b = sym.HermSymbol(pnt * b_raw.diag, pnt * b_raw.sdiag).to(dtype)
        x0 = maxwell.random_block(generator(0, base.device), n, m, dtype,
                                  base.device)

        def h(v, b=b):
            return maxwell.ama_bb(v, d_a, b, base.diel, shift, base.dft)

        def p(v, inv=inv):
            return h_block(v, inv)

        res = lob.lobpcg_sep(h, p, x0, nev)
        lam = res.lambdas.cpu().numpy()
        rep = validate.recompute(
            lam[:nev], res.x[:nev],
            lambda v: maxwell.ama(v, d_a, base.diel, base.dft), shift=shift)
        results.append((f, int(res.iterations), rep))
    if verbose:
        for f, it, rep in results:
            print(f"pnt = {f:<5.2f}*gamma0, iterations = {it}, "
                  f"omega[0] = {rep.omega_re[0]:<8.6f}")
        omega = np.stack([r[2].omega_pnt for r in results])
        omega_re = np.stack([r[2].omega_re for r in results])
        validate.print_standard_deviation(omega, omega_re, nev)
    return results


def rela_cmp(n: int, lattice: str, relas: Sequence[float],
             alpha=DEFAULT_ALPHA, nev: int = NEV,
             dtype: torch.dtype = torch.complex128, verbose: bool = True,
             device="cuda"):
    """Effect of the extra-block relaxation ratio on convergence
    (reference: paper_1_test.py:109-145): a random start of width
    block_width(nev, r), which ``solve`` fits to the solver's width as a
    warm start (truncated, or padded with random columns), as in JAX."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    solver = KPointSolver(cfg, device=device, dtype=dtype)
    results = []
    for r in relas:
        m = block_width(nev, r)
        x0 = maxwell.random_block(generator(0, solver.device), n, m, dtype,
                                  solver.device)
        results.append(solver.solve(alpha, x0=x0, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for r, it in zip(relas, iters):
            print(f"Relaxation ratio = {r:<5.2f}, iterations = {int(it[0])}, "
                  f"runtime = {it[1]:<5.2f}s.")
        validate.print_standard_deviation(omega, omega_re, nev)
    return {"relas": list(relas), "omega_re": omega_re, "iters": iters}


def scal_cmp(n: int, lattice: str, scals: Sequence[float],
             alpha=DEFAULT_ALPHA, nev: int = NEV,
             dtype: torch.dtype = torch.complex128, verbose: bool = True,
             device="cuda"):
    """Frequency invariance under the lattice scaling constant
    (reference: paper_1_test.py:147-184)."""
    results = []
    for s in scals:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev, scal=s)
        solver = KPointSolver(cfg, device=device, dtype=dtype,
                              tol=TOL / s ** 2)
        results.append(solver.solve(np.asarray(alpha), seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for s, it in zip(scals, iters):
            print(f"scal = {s:<5.2f}, iterations = {int(it[0])}, "
                  f"runtime = {it[1]:<5.2f}s.")
        validate.print_standard_deviation(omega, omega_re, nev)
    return {"scals": list(scals), "omega_re": omega_re, "iters": iters}


def eps_cmp(n: int, lattice: str, eps_values: Sequence[float],
            alpha=DEFAULT_ALPHA, nev: int = NEV,
            dtype: torch.dtype = torch.complex128, verbose: bool = True,
            device="cuda"):
    """Band structure vs the isotropic dielectric constant
    (reference: paper_1_test.py:186-217)."""
    results = []
    for e in eps_values:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
        diel = diel_mod.chiral_op(n, lattice, device, eps=e)
        solver = KPointSolver(cfg, device=device, dtype=dtype, diel=diel)
        results.append(solver.solve(alpha, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for e, om, it in zip(eps_values, omega_re, iters):
            print(f"eps = {e:<5.1f}: omega[0:3] = {np.round(om[:3], 5)}, "
                  f"iters = {int(it[0])}")
    return {"eps": list(eps_values), "omega_re": omega_re, "iters": iters}


def grid_cmp(ns: Sequence[int], lattice: str, alpha=DEFAULT_ALPHA,
             nev: int = NEV, dtype: torch.dtype = torch.complex128,
             verbose: bool = True, device="cuda"):
    """Eigenvalues vs grid size (reference: paper_1_test.py:219-255)."""
    results = []
    for n in ns:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
        solver = KPointSolver(cfg, device=device, dtype=dtype)
        results.append(solver.solve(alpha, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for n, om, it in zip(ns, omega_re, iters):
            print(f"N = {n}: omega[0:3] = {np.round(om[:3], 5)}, "
                  f"iters = {int(it[0])}, t = {it[1]:<5.2f}s")
    return {"ns": list(ns), "omega_re": omega_re, "iters": iters}


def library_cmp(n: int, lattice: str, alpha=DEFAULT_ALPHA, nev: int = 6,
                verbose: bool = True, device="cuda"):
    """Compare with a library LOBPCG on the same operator, the analog of
    the reference's cupyx-LOBPCG comparison (test_cpxlobpcg,
    paper_1_test.py:257-270).  The library is SciPy's
    ``scipy.sparse.linalg.lobpcg`` on the host, unpreconditioned, on a
    complex Hermitian ``LinearOperator`` whose products apply the
    solver's complex128 ``ama_bb`` on ``device`` (``torch.lobpcg`` takes
    no complex input).  Returns (our lambdas, the library's), shift
    removed."""
    from scipy.sparse.linalg import LinearOperator, lobpcg

    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex128)
    ours = solver.solve(alpha, seed=0)
    sy = solver.symbols_for(alpha)
    d = 3 * n ** 3

    def a_mat(x_cols):  # the library passes column blocks (d, k)
        x_cols = np.asarray(x_cols).reshape(d, -1)
        blk = torch.as_tensor(np.ascontiguousarray(x_cols.T),
                              device=solver.device).reshape(-1, 3, n, n, n)
        y = maxwell.ama_bb(blk, sy.d_a, sy.b, solver.diel, sy.shift,
                           solver.dft)
        return y.reshape(y.shape[0], -1).T.cpu().numpy()

    op = LinearOperator((d, d), matvec=a_mat, matmat=a_mat,
                        dtype=np.complex128)
    m = nev + 4
    rng = np.random.default_rng(1)
    x0 = rng.random((d, m)) + 1j * rng.random((d, m))
    theta, _, hist = lobpcg(op, x0, largest=False, maxiter=300,
                            retResidualNormsHistory=True)
    lam_lib = np.sort(np.asarray(theta).real)[:nev] - sy.shift
    lam_ours = (2 * np.pi * np.asarray(ours.omega_re)) ** 2
    if verbose:
        print(f"pcx iters = {ours.iterations}, library iters = {len(hist)}")
        print(f"pcx lambdas = {np.round(lam_ours, 6)}")
        print(f"lib lambdas = {np.round(lam_lib, 6)}")
    return lam_ours, lam_lib
