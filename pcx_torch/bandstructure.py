"""Single-k-point solve: ``KPointSolver`` and ``eigen_1p``.

Port of the main-path subset of ``pcx/bandstructure.py``: the complex64
production defaults, the plane-wave cold start and warm-start width fit,
device-built symbols, the warm-start iteration cap and doom check, the
complex128 Rayleigh-Ritz refine (``_refine_jit``) and the 1e-3
spurious-mode gate (reference: eigen_1p, numerical_experiments.py:209-247).

On a complex64 solve the operator's DFT passes run kernel K2 and the
residual/preconditioner pass runs kernel K1; on CPU tensors both wrappers
take their plain PyTorch versions.  The refine runs in complex128 with
torch.fft, as the JAX refine runs its f64 pair operator with XLA products.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcx_torch import interop, lattices, validate
from pcx_torch.config import (MAXITER, NEV, TOL, TYPE_CHIRAL, ProblemConfig,
                              block_width, set_relaxation)
from pcx_torch.kernels.resid_precond import resid_precond
from pcx_torch.operators import maxwell
from pcx_torch.operators import symbols as sym
from pcx_torch.operators.blocks import h_block
from pcx_torch.operators.dft import dft_mats
from pcx_torch.operators.dielectric import DielectricOp, chiral_op
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.solvers.lobpcg import Status
from pcx_torch.solvers.lobpcg_rs import lobpcg_sep_rs
from pcx_torch.utils import dots, norms, real_dtype, sqrt_robust

SOLVER_OPTS = ("ortho_passes", "refresh_every", "floor_patience",
               "col_patience", "lam_tol", "lam_patience", "lam_res_tol")

# Doom-check marks of a warm solve: the first at 24 iterations, then every
# 40 (the JAX segmented solve's boundaries, bandstructure.py:1469-1503).
DOOM_FIRST, DOOM_EVERY = 24, 40


@dataclasses.dataclass
class EigenResult:
    omega: np.ndarray            # penalized frequencies (nev,)
    omega_re: np.ndarray         # recomputed frequencies (nev,)
    lambdas: np.ndarray          # raw Ritz values (m,), shift included
    x: torch.Tensor              # Ritz vectors (m, 3, N, N, N)
    iterations: int
    wall_time: float
    status: int
    report: Optional[validate.ValidationReport]


class Symbols(NamedTuple):
    """k-dependent symbols in the iterate dtype, plus the scalars."""
    d_a: torch.Tensor
    b: sym.HermSymbol
    inv: sym.HermSymbol
    shift: float
    pnt: float


def _shift_pnt(alpha, scal: float):
    (shift, _), pnt = set_relaxation(alpha)
    return float(shift) / scal ** 2, float(pnt)


class KPointSolver:
    """Reusable solver for one (config, dielectric) across k-points.

    ``device`` and ``dtype`` are explicit: complex64 is the GPU production
    iterate (kernels K1 and K2), complex128 the CPU parity iterate.  Every
    validation runs the complex128 Rayleigh-Ritz refine.  ``warm_maxiter``
    caps warm-started solves and ``doom_check`` bails a warm solve whose
    frequency-error bound stalls above ``lam_res_tol`` (see pcx
    KPointSolver.__init__ for the measured rationale of both).
    ``diel``/``parts`` replace the dielectric and the 1-D symbol parts built
    from ``cfg`` (see ``from_arrays``).
    """

    def __init__(self, cfg: ProblemConfig, *, device, dtype: torch.dtype,
                 tol: float = TOL, maxiter: int = MAXITER,
                 solver_opts: Optional[dict] = None,
                 warm_maxiter: int = 150, doom_check: bool = True,
                 diel: Optional[DielectricOp] = None,
                 parts: Optional[sym.SymbolParts] = None):
        if cfg.diel_type != TYPE_CHIRAL:
            raise NotImplementedError(
                f"pcx_torch ports the chiral dielectric only, not "
                f"{cfg.diel_type!r}")
        if dtype not in (torch.complex64, torch.complex128):
            raise ValueError(f"dtype must be complex64 or complex128, "
                             f"got {dtype}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.rdt = real_dtype(dtype)
        self.tol = tol
        self.maxiter = maxiter
        opts = dict(solver_opts or {})
        unknown = sorted(set(opts) - set(SOLVER_OPTS))
        if unknown:
            raise ValueError(f"unknown solver_opts {unknown}; supported: "
                             f"{SOLVER_OPTS}")
        if dtype == torch.complex64:
            # complex64 robustness defaults of the JAX solver
            # (bandstructure.py:261-280): two orthogonalization passes,
            # HX/HP refresh every 8 iterations, FLOOR patience 6.
            opts.setdefault("ortho_passes", 2)
            opts.setdefault("refresh_every", 8)
            opts.setdefault("floor_patience", 6)
        self.solver_opts = opts
        self.warm_maxiter = int(warm_maxiter)
        self.doom_check = bool(doom_check)
        self.doom_tol = float(opts.get("lam_res_tol", 1e-3))
        self.last_doom = None   # (it, worst bound) of the last doom bail
        ct = (lattices.ct_matrix(cfg.lattice) if cfg.lattice else np.eye(3))
        self.parts = parts if parts is not None else sym.symbol_parts(
            cfg.n, cfg.k, ct, cfg.scal, self.device)
        self.diel = diel if diel is not None else chiral_op(
            cfg.n, cfg.lattice, self.device,
            eps=float(cfg.eps_opt) if cfg.eps_opt else 0.0)
        self.dft = dft_mats(cfg.n, dtype, self.device)

    @classmethod
    def from_arrays(cls, cfg: ProblemConfig, *, scale, d1, d0, ct, device,
                    dtype: torch.dtype, **kw) -> "KPointSolver":
        """A solver on state given as numpy arrays — the ε⁻¹ scale of a
        chiral dielectric and the 1-D symbol parts (d1, d0, ct), e.g. taken
        from the JAX package's KPointSolver — instead of the geometry and
        stencils (see ``pcx_torch.interop``)."""
        return cls(cfg, device=device, dtype=dtype,
                   diel=interop.dielectric(scale, device),
                   parts=interop.symbol_parts(d1, d0, ct, device), **kw)

    def block_width(self, alpha) -> int:
        (_, rlx), _ = set_relaxation(alpha)
        return block_width(self.cfg.nev, rlx)

    def symbols_for(self, alpha) -> Symbols:
        """Curl, penalty and preconditioner symbols of one k-point, built on
        the device in complex128 from the 1-D parts and cast to the iterate
        dtype."""
        shift, pnt = _shift_pnt(alpha, self.cfg.scal)
        d_a = sym.build_curl(self.parts, alpha)
        return Symbols(d_a.to(self.dtype),
                       sym.penalty(d_a, pnt).to(self.dtype),
                       sym.inverse_penalized(d_a, pnt, shift).to(self.dtype),
                       shift, pnt)

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _x0_cold(self, alpha, m: int, seed: int) -> torch.Tensor:
        """Plane-wave cold start: transverse plane waves at the m/2 lowest
        vacuum frequencies plus 1e-2 jitter from a generator seeded with
        ``seed`` (pcx maxwell.plane_wave_cols / plane_wave_scatter)."""
        d_a = sym.build_curl(self.parts, alpha).cpu().numpy()
        idx, amps = maxwell.plane_wave_cols(d_a, m)
        return maxwell.plane_wave_scatter(idx, amps, self.cfg.n, self.dtype,
                                          self.device, self._generator(seed))

    def _fit(self, x: torch.Tensor, m: int, seed: int) -> torch.Tensor:
        """Warm-start width adaptation: truncate, or pad with random columns
        (reference: numerical_experiments.py:425-432)."""
        if x.shape[0] >= m:
            return x[:m]
        extra = maxwell.random_block(self._generator(seed + 1), self.cfg.n,
                                     m - x.shape[0], self.dtype, self.device)
        return torch.cat((x, extra))

    def _rp_fused(self, inv: sym.HermSymbol, m: int):
        """The rp_fused hook of the solver, running kernel K1 on the flat
        (m, 3N^3) blocks."""
        n3 = self.cfg.n ** 3
        inv_diag = inv.diag.reshape(3, n3)
        inv_sd = inv.sdiag.reshape(3, n3)

        def rp(xf, hxf, lam):
            w, sumsq = resid_precond(xf.view(m, 3, n3), hxf.view(m, 3, n3),
                                     lam, inv_diag, inv_sd)
            return w.view(m, -1), sumsq

        return rp

    def _doom_monitor(self):
        """Host-side doom check of a warm solve at the marks 24, 64, 104,
        ...: bail (status MAXITER) when the frequency-error admissibility
        bound res_i / (doom_tol 4 pi sqrt(max(|lambda_i|, 1))) of a tracked
        column exceeds 10, or exceeds 1 while improving < 15% since the
        previous mark (pcx bandstructure.py:238-258, 1486-1503)."""
        nev = self.cfg.nev
        prev = [None]

        def monitor(it, res, lambdas):
            if it < DOOM_FIRST or (it - DOOM_FIRST) % DOOM_EVERY:
                return False
            lam = np.abs(lambdas[:nev].cpu().numpy())
            cap = self.doom_tol * 4.0 * np.pi * np.sqrt(np.maximum(lam, 1.0))
            with np.errstate(invalid="ignore"):
                viol = res[:nev] / cap
            worst = float(np.nanmax(viol)) if viol.size else 0.0
            doomed = worst > 10.0 or (prev[0] is not None and worst > 1.0
                                      and worst > 0.85 * prev[0])
            if doomed:
                self.last_doom = (it, worst * self.doom_tol)
                return True
            prev[0] = worst
            return False

        return monitor

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve(self, alpha, x0: Optional[torch.Tensor] = None, seed: int = 0,
              validate_result: bool = True,
              verbose: bool = False) -> EigenResult:
        cfg = self.cfg
        alpha = np.asarray(alpha, dtype=float)
        m = self.block_width(alpha)
        warm = x0 is not None
        if x0 is None:
            x0 = self._x0_cold(alpha, m, seed)
        else:
            x0 = x0.to(device=self.device, dtype=self.dtype)
            if x0.shape[0] != m:
                x0 = self._fit(x0, m, seed)

        self._sync()
        t0 = time.time()
        sy = self.symbols_for(alpha)

        def h_func(v):
            return maxwell.ama_bb(v, sy.d_a, sy.b, self.diel, sy.shift,
                                  self.dft)

        def p_func(v):
            return h_block(v, sy.inv)

        rp = (self._rp_fused(sy.inv, m) if self.dtype == torch.complex64
              else None)
        self.last_doom = None
        limit = (min(self.maxiter, self.warm_maxiter)
                 if warm and self.warm_maxiter > 0 else None)
        monitor = self._doom_monitor() if warm and self.doom_check else None
        res = lobpcg_sep_rs(h_func, p_func, x0, cfg.nev, tol=self.tol,
                            maxiter=self.maxiter, rp_fused=rp, limit=limit,
                            monitor=monitor, **self.solver_opts)
        self._sync()
        wall = time.time() - t0

        lambdas = res.lambdas.cpu().numpy().astype(float)
        status = res.status
        report = None
        omega = omega_re = None
        if status in (Status.CONVERGED, Status.FLOOR, Status.MAXITER):
            if validate_result:
                report, lambdas = self._refine_report(alpha, res.x,
                                                      verbose=verbose)
                omega, omega_re = report.omega_pnt, report.omega_re
            else:
                lam = lambdas[:cfg.nev] - (sy.shift if sy.shift > 0 else 0.0)
                omega = np.array([sqrt_robust(v) * cfg.scal / (2 * np.pi)
                                  for v in lam])
                omega_re = omega
        return EigenResult(omega=omega, omega_re=omega_re, lambdas=lambdas,
                           x=res.x, iterations=res.iterations,
                           wall_time=wall, status=status, report=report)

    def refine_stats(self, alpha, x: torch.Tensor):
        """complex128 Rayleigh-Ritz refine of the iterated subspace and the
        validation statistics of its leading nev modes (pcx
        ``_refine_jit``): returns (theta (m,), lam_re (nev,), res (nev,)) as
        numpy, theta with the shift included."""
        cfg, nev = self.cfg, self.cfg.nev
        shift, pnt = _shift_pnt(alpha, cfg.scal)
        d_a = sym.build_curl(self.parts, alpha)
        b = sym.penalty(d_a, pnt)
        m = x.shape[0]
        xf = x.to(torch.complex128).reshape(m, -1)
        hx = maxwell.ama_bb(xf.view(x.shape), d_a, b, self.diel, shift)
        t = rr.gram(xf, hx.reshape(m, -1))
        del hx
        theta, c = rr.pencil_eigh(t, rr.gram(xf, xf))
        y = rr.mix(c[:, :nev], xf)
        del xf
        ay = maxwell.ama(y.view((nev,) + x.shape[1:]), d_a,
                         self.diel).reshape(nev, -1)
        den = dots(y, y).real.clamp(min=1e-30)
        lam_re = dots(y, ay).real / den
        res = norms(ay - (theta[:nev] - shift)[:, None] * y) / den.sqrt()
        return (theta.cpu().numpy(), lam_re.cpu().numpy(),
                res.cpu().numpy())

    def _refine_report(self, alpha, x, verbose=False,
                       raise_on_spurious=True):
        theta, lam_re, res = self.refine_stats(alpha, x)
        shift, _ = _shift_pnt(alpha, self.cfg.scal)
        report = validate.recompute(
            theta[:self.cfg.nev], shift=shift, scal=self.cfg.scal,
            stats=(lam_re, res), verbose=verbose,
            raise_on_spurious=raise_on_spurious)
        return report, theta

    def validate_solution(self, alpha, result: EigenResult,
                          verbose: bool = False,
                          raise_on_spurious: bool = True):
        """Validation report for an existing solve at ``alpha`` (no
        re-solve)."""
        return self._refine_report(np.asarray(alpha, dtype=float), result.x,
                                   verbose=verbose,
                                   raise_on_spurious=raise_on_spurious)[0]


def eigen_1p(n: int, lattice: str, alpha, *, device,
             dtype: torch.dtype = torch.complex128,
             diel_type: str = TYPE_CHIRAL, nev: int = NEV, tol: float = TOL,
             maxiter: int = MAXITER, seed: int = 0, eps_opt: int = 0,
             verbose: bool = True, **solver_kw) -> EigenResult:
    """Single-k-point solve (reference: numerical_experiments.py:209-247)."""
    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type, nev=nev,
                        eps_opt=eps_opt)
    kps = KPointSolver(cfg, device=device, dtype=dtype, tol=tol,
                       maxiter=maxiter, **solver_kw)
    result = kps.solve(np.asarray(alpha, dtype=float), seed=seed,
                       verbose=verbose)
    if verbose:
        print(f"n = {n}, lattice: {lattice}, "
              f"alpha/pi = {np.asarray(alpha) / np.pi}, "
              f"iter = {result.iterations}, "
              f"runtime = {result.wall_time:<6.3f}s, status = {result.status}")
    return result
