"""Precision and convergence-order studies.

Port of ``pcx/experiments/precision.py`` (reference: paper_2/
paper_2_test.py:22-84 global/partial precision, :146-190 and :363-401 the
order studies, paper_1_test.py:272-303 full FP32).  Every runner takes a
``device`` (default ``"cuda"``); on the card a complex64 ``KPointSolver``
solve runs kernels K1 and K2.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pcx_torch import validate
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import NEV, ProblemConfig
from pcx_torch.operators import dielectric as diel_mod
from pcx_torch.operators import maxwell
from pcx_torch.operators.blocks import h_block
from pcx_torch.solvers import lobpcg as lob
from pcx_torch.utils import generator

_PI = np.pi
DEFAULT_ALPHA = np.array([_PI, _PI, _PI])


def global_precision_cmp(n: int, lattice: str, alpha=DEFAULT_ALPHA,
                         nev: int = NEV, verbose: bool = True,
                         device="cuda"):
    """Full double against full single precision solve
    (reference: global_precision_cmp, paper_2_test.py:22-55)."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    r64 = KPointSolver(cfg, device=device,
                       dtype=torch.complex128).solve(alpha, seed=0)
    r32 = KPointSolver(cfg, device=device,
                       dtype=torch.complex64).solve(alpha, seed=0)
    l_diff = np.abs(r64.omega_re - r32.omega_re)
    if verbose:
        print(f"Double: ({r64.iterations}, {r64.wall_time:<6.3f}s).")
        print(f"Single: ({r32.iterations}, {r32.wall_time:<6.3f}s).")
        for i in range(nev):
            print(f"i = {i + 1:<4d}, omega_diff = {l_diff[i]:<6.3e}")
    return {"double": r64, "single": r32, "omega_diff": l_diff}


def partial_precision_cmp(n: int, lattice: str, alpha=DEFAULT_ALPHA,
                          nev: int = NEV, verbose: bool = True,
                          device="cuda"):
    """Double iterate with a single-precision preconditioner (the
    reference's validated mixed scheme, lobpcg.py:494-629 /
    paper_2_test.py:57-84): the complex LOBPCG (``solvers.lobpcg``) in
    complex128 with ``h_block`` applied in complex64."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex128)
    full = solver.solve(alpha, seed=0)

    sy = solver.symbols_for(alpha)
    inv32 = sy.inv.to(torch.complex64)
    m = solver.block_width(alpha)
    x0 = maxwell.random_block(generator(0, solver.device), n, m,
                              torch.complex128, solver.device)

    def h(v):
        return maxwell.ama_bb(v, sy.d_a, sy.b, solver.diel, sy.shift,
                              solver.dft)

    def p32(v):
        return h_block(v.to(torch.complex64), inv32).to(torch.complex128)

    res = lob.lobpcg_sep(h, p32, x0, nev)
    rep = validate.recompute(
        res.lambdas.cpu().numpy()[:nev], res.x[:nev],
        lambda v: maxwell.ama(v, sy.d_a, solver.diel, solver.dft),
        shift=sy.shift)
    diff = np.abs(rep.omega_re - full.omega_re)
    if verbose:
        print(f"Full double:   iters = {full.iterations}")
        print(f"Mixed precond: iters = {int(res.iterations)}")
        print(f"max omega diff = {diff.max():<6.3e}")
    return {"full": full, "mixed_iters": int(res.iterations),
            "omega_diff": diff}


def precision_test(ns: Sequence[int] = (16, 32, 64, 128),
                   lattice: str = "sc_curv", alpha=DEFAULT_ALPHA,
                   diel_type: str = "pseudochiral_crossdof", k: int = 5,
                   nev: int = NEV, dtype: torch.dtype = torch.complex128,
                   verbose: bool = True, device="cuda"):
    """Grid-refinement order study at high stencil order
    (reference: precision_test, paper_2_test.py:363-401).  Returns
    ({N: omega_re}, {N: (iterations, seconds)})."""
    freqs = {}
    iters = {}
    for n in ns:
        cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type,
                            nev=nev, k=k)
        solver = KPointSolver(cfg, device=device, dtype=dtype)
        r = solver.solve(alpha, seed=0)
        freqs[n] = r.omega_re
        iters[n] = (r.iterations, r.wall_time)
        if verbose:
            print(f"n = {n}, iterations = {r.iterations}, "
                  f"runtime = {r.wall_time:<5.2f}s.")
    if verbose:
        print("\nPrecision results:")
        ns_l = list(ns)
        for i in range(nev):
            diffs = [abs(freqs[ns_l[j + 1]][i] - freqs[ns_l[j]][i])
                     for j in range(len(ns_l) - 1)]
            line = ", ".join(f"{d:<10.2e}" for d in diffs)
            if len(diffs) >= 2 and diffs[-1] > 0:
                order = (np.log(diffs[0] / diffs[-1]) / np.log(2)
                         / (len(ns_l) - 2))
            else:
                order = float("nan")
            print(f"{i + 1:<4d}: {line}, average order = {order:<6.2f}.")
    return freqs, iters


def largek_smooth_cmp(ns: Sequence[int] = (16, 32, 64, 128),
                      k: int = 5, nev: int = 8,
                      dtype: torch.dtype = torch.complex128,
                      verbose: bool = True, device="cuda"):
    """Order study with a smooth dielectric and high-order stencils, where
    the full stencil order is observable
    (reference: largek_smooth_cmp, paper_2_test.py:146-190)."""
    freqs = {}
    for n in ns:
        cfg = ProblemConfig(n=n, lattice="sc_curv", nev=nev, k=k)
        diel = diel_mod.smooth_eps_op(n, device)
        solver = KPointSolver(cfg, device=device, dtype=dtype, diel=diel)
        r = solver.solve(DEFAULT_ALPHA, seed=0)
        freqs[n] = r.omega_re
        if verbose:
            print(f"N = {n} is done computing ({r.iterations} iters).")
    if verbose:
        validate.observed_order(freqs)
    return freqs
