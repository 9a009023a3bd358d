"""Structural and mathematical-property experiments.

Port of ``pcx/experiments/structure.py`` (reference: paper_2/
paper_2_test.py:87-361): eigenvector uniqueness, large-k convergence, the
edge/volume index census, the eps^{-1} D-matrix cross-validation, the SDD
and HPD checks, band-library statistics and the extreme anisotropic case.
Every runner that touches the device takes a ``device`` (default
``"cuda"``).
"""

from __future__ import annotations

import cmath
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pcx_torch import geometry
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import NEV, ProblemConfig
from pcx_torch.io import load_reference_band_json
from pcx_torch.operators import dense as dense_mod
from pcx_torch.operators import dielectric as diel_mod
from pcx_torch.operators import maxwell
from pcx_torch.solvers import lobpcg as lob
from pcx_torch.solvers.rayleigh_ritz import power_method
from pcx_torch.utils import generator

_PI = np.pi
DEFAULT_ALPHA = np.array([_PI, _PI, _PI])


def eigenvector_cmp(n: int, lattice: str, alpha=DEFAULT_ALPHA,
                    nev: int = NEV, verbose: bool = True, device="cuda"):
    """Eigenvector uniqueness up to a unit complex phase across two random
    starts (reference: eigenvector_cmp, paper_2_test.py:87-116), with the
    random cold start: the study's premise is independent starting
    subspaces, which the deterministic plane-wave start would defeat.
    Returns [(omega difference, vector difference, |z|, arg z)]."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex128,
                          x0_mode="random")
    r1 = solver.solve(alpha, seed=0)
    r2 = solver.solve(alpha, seed=123)
    out = []
    x1 = r1.x.reshape(r1.x.shape[0], -1).cpu().numpy()
    x2 = r2.x.reshape(r2.x.shape[0], -1).cpu().numpy()
    for i in range(nev):
        z = x2[i, 0] / x1[i, 0]
        r, c = abs(z), cmath.phase(z)
        x_diff = np.linalg.norm(x1[i] * z - x2[i])
        l_diff = abs(r1.omega_re[i] - r2.omega_re[i])
        out.append((l_diff, x_diff, r, c))
        if verbose:
            print(f"i = {i + 1:<4d}, omega_diff = {l_diff:<6.2e}, "
                  f"x_diff = {x_diff:<6.2e}, <x1,x2> = ({r:<6.2f}, "
                  f"{c / _PI:<6.2f}pi).")
    return out


def largek_cmp(ns: Sequence[int], lattice: str = "sc_curv",
               alpha=DEFAULT_ALPHA, dtype: torch.dtype = torch.complex128,
               verbose: bool = True, device="cuda"):
    """High-order stencil convergence with the N-matched order policy
    k(N) = round(16.30 ln(N-10) - 58.12), N > 10
    (reference: largek_cmp, paper_2_test.py:118-144)."""
    n2k = lambda n: max(1, round(16.30 * np.log(n - 10) - 58.12))  # noqa: E731
    results = []
    for n in ns:
        k = n2k(n)
        cfg = ProblemConfig(n=n, lattice=lattice, nev=4, k=k)
        solver = KPointSolver(cfg, device=device, dtype=dtype)
        r = solver.solve(alpha, seed=0)
        results.append(r.omega_re[2])
        if verbose:
            print(f"N = {n} (k = {k}) is done computing.")
    henka = np.abs(np.diff(np.asarray(results)))
    if verbose:
        for h in henka:
            print(f"{h:<6.3e}")
    return np.asarray(results), henka


def edge_volume_index_cmp(n: int, lattice: str = "sc_curv",
                          verbose: bool = True):
    """Census of edge-vs-volume DoF membership mismatches, per component
    (reference: edge_volume_index_cmp, paper_2_test.py:197-231)."""
    em = geometry.edge_mask(n, lattice)
    vm = geometry.volume_mask(n, lattice)
    nn = n ** 3
    mismatches = [int(np.sum(em[c] != vm)) for c in range(3)]
    if verbose:
        for c, label in enumerate("xyz"):
            print(f"Number/Ratio of different {label}-edge and volume "
                  f"indices: {mismatches[c]}, {mismatches[c] / nn:<6.3e}.")
        print("When volume index is True,")
        for i1 in (0, 1):
            for i2 in (0, 1):
                for i3 in (0, 1):
                    cnt = int(np.sum(vm & (em[0] == i1) & (em[1] == i2)
                                     & (em[2] == i3)))
                    print(f"({i1},{i2},{i3}), number = {cnt}.")
        ee = [int(np.sum(em[0] != em[1])), int(np.sum(em[0] != em[2])),
              int(np.sum(em[2] != em[1]))]
        print(f"Number of different edge-edge indices: {ee}.")
    return mismatches


def dmat_cmp(n: int, types: Sequence[str], lattice: str = "sc_curv",
             k: int = 1, verbose: bool = True, device="cuda"):
    """Entrywise and spectral comparison of two eps^{-1} constructions
    (reference: dmat_cmp, paper_2_test.py:233-257): dense at this small N,
    and the difference's norm also bounded matrix-free by the power method
    from a seeded complex normal start."""
    op1 = diel_mod.build(types[0], n, lattice, device, k=k)
    op2 = diel_mod.build(types[1], n, lattice, device, k=k)
    m1 = dense_mod.materialize(op1, n, device)
    m2 = dense_mod.materialize(op2, n, device)
    report = dense_mod.dense_diff_report(m1, m2, types, verbose=verbose)

    def diff_op(v):
        return op1(v) - op2(v)

    gen = generator(0, device)
    shape = (1, 3, n, n, n)
    x0 = torch.complex(
        torch.randn(shape, generator=gen, dtype=torch.float64, device=device),
        torch.randn(shape, generator=gen, dtype=torch.float64, device=device))
    # (D1 - D2)^H (D1 - D2) = (D1 - D2)^2: both constructions are Hermitian
    rho, _, _ = power_method(lambda v: diff_op(diff_op(v)), x0, maxiter=200,
                             tol=1e-6)
    report["spectral_radius_pm"] = float(rho) ** 0.5
    if verbose:
        print(f"Spectrum radius (power method) = "
              f"{report['spectral_radius_pm']:<6.3e}.")
    return report


def check_sdd(n: int, k: int = 1, lattice: str = "sc_curv",
              diel_type: str = "pseudochiral_crossdof", eps_opt: int = 0,
              verbose: bool = True, device="cuda") -> int:
    """Strict-diagonal-dominance census of the eps^{-1} operator,
    matrix-free (reference: check_sdd / check_pseudochiral_crossdof_sdd,
    paper_2_test.py:259-281)."""
    op = diel_mod.build(diel_type, n, lattice, device, eps_opt=eps_opt, k=k)
    n_bad = op.sdd_violations()
    if verbose:
        print(f"SDD not satisfied n_row = {n_bad}.")
    return n_bad


def check_component_hpd(n: int, k: int = 1, eps_opt: int = 0,
                        lattice: str = "sc_curv", verbose: bool = True,
                        device="cuda"):
    """The smallest eigenvalues of the assembled cross-DoF eps^{-1} must be
    positive (reference: check_component_HPD, paper_2_test.py:283-297):
    ``lobpcg_default`` on the operator as a (function, size) pair."""
    op = diel_mod.build("pseudochiral_crossdof", n, lattice, device,
                        eps_opt=eps_opt, k=k)
    d = 3 * n ** 3

    def h_vec(v):
        return op(v.reshape(3, n, n, n)).reshape(-1)

    res = lob.lobpcg_default((h_vec, d), nev=2, rlx=4, maxiter=300,
                             device=device)
    eig_s = res.lambdas[:2].cpu().numpy()
    if verbose:
        print(f"Smallest eigenvalues of eps^-1: {eig_s} "
              f"({'HPD' if eig_s[0] > 0 else 'NOT PD'}).")
    return eig_s


def condition_number(op, n: int, verbose: bool = True,
                     device="cuda") -> float:
    """Condition number of a block operator on (m, 3, n, n, n) from its
    extreme eigenvalues (reference: condition_number,
    numerical_experiments.py:160-177)."""
    x0 = maxwell.random_block(generator(0, device), n, 6, torch.complex128,
                              device)
    small = lob.lobpcg_sep_softlock(op, lambda v: v, x0, 2, tol=1e-6,
                                    maxiter=300)
    large = lob.lobpcg_sep_max(op, x0, 2, tol=1e-6, maxiter=300)
    cond = float(large.lambdas[0] / small.lambdas[0])
    if verbose:
        print(f"Condition number: {cond:<6.3f}.")
    return cond


def bandgap_pseudo_cmp(n: int, lattice: str, eps_opt: int = 0,
                       output_dir: str = "output", verbose: bool = True):
    """Statistical comparison of the trivial and cross-DoF band libraries
    ``{output_dir}/{type}/bandgap_{lattice}{eps_opt}.json`` (reference:
    bandgap_pseudo_cmp, paper_2_test.py:299-337, whose comparison files
    always carry the eps_opt suffix, :305-307)."""
    suffix = str(eps_opt)
    fq, it = {}, {}
    for t in ("chiral", "pseudochiral_trivial", "pseudochiral_crossdof"):
        path = f"{output_dir}/{t}/bandgap_{lattice}{suffix}.json"
        fq[t], it[t] = load_reference_band_json(path, lattice, n)
    f1 = fq["pseudochiral_trivial"]
    f2 = fq["pseudochiral_crossdof"]
    sel = np.abs(f2) > 1e-5
    fq_diff = np.abs(f1[sel] - f2[sel]) / f2[sel]
    stats = {
        "max": float(np.max(fq_diff)),
        "min": float(np.min(fq_diff)),
        "mean": float(np.mean(fq_diff)),
        "iter_means": {t: float(np.mean(it[t][:, 0])) for t in it},
        "iter_stds": {t: float(np.std(it[t][:, 0])) for t in it},
    }
    if verbose:
        print(f"max = {stats['max']:<6.3e}, min = {stats['min']:<6.3e}, "
              f"mean = {stats['mean']:<6.3e}.")
        print(f"Average iterations: {stats['iter_means']}")
        print(f"Deviation: {stats['iter_stds']}")
    return stats


def compute_extreme_case(n: int, lattice: str = "sc_curv",
                         diel_type: str = "pseudochiral_trivial",
                         nev: int = NEV, seed: int = 7,
                         output_dir: Optional[str] = None,
                         verbose: bool = True, device="cuda"):
    """Extreme anisotropic eps with eigenvalue spread 16x..256x under a
    random unitary conjugation; tight tolerance, long history
    (reference: compute_extreme_case, paper_2_test.py:339-361)."""
    alpha = np.array([_PI / 7, 3 * _PI / 5, 4 * _PI / 13])
    rng = np.random.default_rng(seed)
    d = np.diag([1 / 16, 1 / 64, 1 / 256])
    u, _ = np.linalg.qr(rng.random((3, 3)) + 1j * rng.random((3, 3)))
    e = u @ d @ u.conj().T
    eps_mat = np.array([e[0, 0].real, e[1, 1].real, e[2, 2].real,
                        e[0, 1], e[0, 2], e[1, 2]])

    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type, nev=nev)
    diel = diel_mod.build(diel_type, n, lattice, device, eps_mat=eps_mat)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex128,
                          tol=1e-9, maxiter=10000, diel=diel)
    r = solver.solve(alpha, seed=seed)
    if verbose:
        print(f"Extreme case: {lattice}, {diel_type}, n={n}, "
              f"iterations = {r.iterations}, runtime = {r.wall_time:<6.3f}s.")
    if output_dir:
        os.makedirs(f"{output_dir}/{diel_type}", exist_ok=True)
        np.array([r.iterations, r.wall_time]).tofile(
            f"{output_dir}/{diel_type}/info_{lattice}.bin")
    return r
