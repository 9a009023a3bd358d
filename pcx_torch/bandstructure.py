"""The single-k-point solve (``KPointSolver``, ``eigen_1p``) and the band
sweep (``bandgap``).

Port of the main-path subset of ``pcx/bandstructure.py``: the complex64
production defaults, the plane-wave cold start and warm-start width fit,
device-built symbols, the warm-start iteration cap and doom check, the
complex128 Rayleigh-Ritz refine (``_refine_jit``), the 1e-3 spurious-mode
gate (reference: eigen_1p, numerical_experiments.py:209-247), and the
checkpointed, resumable, warm-started sweep over a Brillouin-zone path
(reference: bandgap, numerical_experiments.py:313-496).

Every dielectric of ``pcx_torch.operators.dielectric`` runs through these
entry points (``diel_type``: chiral, pseudochiral_trivial,
pseudochiral_crossdof), with every solver of the JAX package's
``solver=``: the production soft-locking LOBPCG and its ``nolock``,
``descent`` and ``mixed`` forms, ``davidson`` and ``jd``.

On a complex64 solve the operator's DFT passes run kernel K2 and, for the
LOBPCG forms but ``mixed``, the residual/preconditioner pass runs kernel
K1, whatever the dielectric; with
``solver_opts={"rr_gram": "pallas"}`` the Rayleigh-Ritz Gram of the LOBPCG
forms runs kernel K3 (any dtype).  On CPU tensors the wrappers take their plain PyTorch
versions.  The refine runs in complex128 with
torch.fft, as the JAX refine runs its f64 pair operator with XLA products.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcx_torch import interop, lattices, validate
from pcx_torch.config import (GAP, MAXITER, NEV, TOL, TYPE_CHIRAL,
                              ProblemConfig, block_width, set_relaxation)
from pcx_torch.io import BandLibrary
from pcx_torch.kernels.resid_precond import resid_precond
from pcx_torch.operators import maxwell
from pcx_torch.operators import symbols as sym
from pcx_torch.operators.blocks import h_block, h_block_planes
from pcx_torch.operators.dft import dft_mats
from pcx_torch.operators import dielectric as diel_mod
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.solvers.davidson import davidson_sep, jd_sep
from pcx_torch.solvers.lobpcg import Status
from pcx_torch.solvers.lobpcg_rs import lobpcg_sep_rs
from pcx_torch.metrics import RunLogger
from pcx_torch.utils import (GREEN, RED, RESET, YELLOW, dots, norms,
                             real_dtype, sqrt_robust)

SOLVER_OPTS = ("ortho_passes", "refresh_every", "floor_patience",
               "col_patience", "lam_tol", "lam_patience", "lam_res_tol",
               "rr_gram", "use_p", "subspace")
# Keys of solver_opts that KPointSolver itself takes and pops before the
# rest reach the solver (pcx/bandstructure.py:238, 255-257).
SOLVE_OPTS = ("warm_maxiter", "doom_check", "doom_tol")

# Solver variants (reference eigen_1p's ``solver`` argument,
# numerical_experiments.py:209), as pcx KPointSolver takes them
# (pcx/bandstructure.py:206-208): the production soft-locking LOBPCG, the
# same without locking, with a bfloat16 preconditioner, without the
# conjugate block, and block Davidson and Jacobi-Davidson.
SOLVERS = ("softlock", "nolock", "mixed", "descent", "davidson", "jd")
DAVIDSONS = ("davidson", "jd")
# solver_opts keys of the LOBPCG solver that the JAX complex route, which
# serves Davidson and JD, refuses (pcx/bandstructure.py:422-432); Davidson
# and JD ignore the other LOBPCG keys, and take ``subspace`` alone.
LOBPCG_ONLY_OPTS = ("rr_gram", "col_patience", "lam_tol", "lam_patience",
                    "lam_res_tol")

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
    validation runs the complex128 Rayleigh-Ritz refine.

    ``solver_opts`` is the dict the JAX package's KPointSolver takes: the
    solver's options (``SOLVER_OPTS``; ``rr_gram="pallas"`` forms the
    Rayleigh-Ritz Gram with kernel K3) and three keys popped here, as
    there: ``warm_maxiter`` (default 150) caps warm-started solves,
    ``doom_check`` (default True) bails a warm solve whose frequency-error
    bound stalls above ``doom_tol`` (default ``lam_res_tol``, else 1e-3);
    see pcx KPointSolver.__init__ for the measured rationale of both.
    ``solver``: ``"softlock"`` (production), ``"nolock"`` (every column
    stays active), ``"descent"`` (no conjugate block: ``use_p=False``) or
    ``"mixed"`` (the preconditioner in bfloat16 on real and imaginary
    planes, K1 off), as the JAX package's pair-layout route serves them
    (pcx/bandstructure.py:259, 312-316, 484-496, 517-518); ``"davidson"``
    and ``"jd"`` (``solvers.davidson``, capacity max(subspace, 3m) with
    ``solver_opts["subspace"]``, default 40), one unsegmented solve with
    no warm cap and no doom check (pcx/bandstructure.py:372-376, 457-461).
    ``diel``/``parts`` replace the dielectric built from ``cfg`` by
    ``dielectric.build`` and the 1-D symbol parts (see ``from_arrays``).
    """

    def __init__(self, cfg: ProblemConfig, *, device, dtype: torch.dtype,
                 tol: float = TOL, maxiter: int = MAXITER,
                 solver: str = "softlock",
                 solver_opts: Optional[dict] = None,
                 diel: Optional[diel_mod.DielectricOp] = None,
                 parts: Optional[sym.SymbolParts] = None):
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
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
        self.warm_maxiter = int(opts.pop("warm_maxiter", 150))
        self.doom_check = bool(opts.pop("doom_check", True))
        self.doom_tol = float(opts.pop("doom_tol",
                                       opts.get("lam_res_tol", 1e-3)))
        unknown = sorted(set(opts) - set(SOLVER_OPTS))
        if unknown:
            raise ValueError(f"unknown solver_opts {unknown}; supported: "
                             f"{SOLVER_OPTS + SOLVE_OPTS}")
        refused = sorted(set(opts) & set(LOBPCG_ONLY_OPTS if solver in
                                         DAVIDSONS else ("subspace",)))
        if refused:
            raise ValueError(f"solver_opts {refused} are not options of "
                             f"solver {solver!r}")
        if dtype == torch.complex64:
            # complex64 robustness defaults of the JAX solver
            # (bandstructure.py:261-280): two orthogonalization passes,
            # HX/HP refresh every 8 iterations, FLOOR patience 6.
            opts.setdefault("ortho_passes", 2)
            opts.setdefault("refresh_every", 8)
            opts.setdefault("floor_patience", 6)
        if solver == "descent":
            opts.setdefault("use_p", False)
        self.solver_opts = opts
        self.solver = solver
        self.locking = solver != "nolock"
        self.last_doom = None   # (it, worst bound) of the last doom bail
        ct = (lattices.ct_matrix(cfg.lattice) if cfg.lattice else np.eye(3))
        self.parts = parts if parts is not None else sym.symbol_parts(
            cfg.n, cfg.k, ct, cfg.scal, self.device)
        self.diel = diel if diel is not None else diel_mod.build(
            cfg.diel_type, cfg.n, cfg.lattice, self.device,
            eps_opt=cfg.eps_opt, k=cfg.k)
        self.dft = dft_mats(cfg.n, dtype, self.device)

    @classmethod
    def from_arrays(cls, cfg: ProblemConfig, *, d1, d0, ct, device,
                    dtype: torch.dtype, scale=None,
                    diel: Optional[diel_mod.DielectricOp] = None,
                    **kw) -> "KPointSolver":
        """A solver on state given as numpy arrays, e.g. taken from the JAX
        package's KPointSolver, instead of the geometry and stencils: the
        1-D symbol parts (d1, d0, ct) and either the ε⁻¹ ``scale`` of a
        chiral dielectric or a ``diel`` from ``interop.dielectric_from``."""
        if (scale is None) == (diel is None):
            raise ValueError("pass exactly one of scale= and diel=")
        if diel is None:
            diel = interop.dielectric(scale, device)
        return cls(cfg, device=device, dtype=dtype, diel=diel,
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

        if self.solver == "mixed":
            p_func = _p_func_bf16(sy.inv)
        else:
            def p_func(v):
                return h_block(v, sy.inv)

        self.last_doom = None
        if self.solver in DAVIDSONS:
            fn = davidson_sep if self.solver == "davidson" else jd_sep
            kw = {k: v for k, v in self.solver_opts.items()
                  if k == "subspace"}
            res = fn(h_func, p_func, x0, cfg.nev, tol=self.tol,
                     maxiter=self.maxiter, **kw)
        else:
            # K1 computes the preconditioner in float32: off for "mixed"
            rp = (self._rp_fused(sy.inv, m)
                  if self.dtype == torch.complex64 and self.solver != "mixed"
                  else None)
            limit = (min(self.maxiter, self.warm_maxiter)
                     if warm and self.warm_maxiter > 0 else None)
            monitor = (self._doom_monitor() if warm and self.doom_check
                       else None)
            res = lobpcg_sep_rs(h_func, p_func, x0, cfg.nev, tol=self.tol,
                                maxiter=self.maxiter, locking=self.locking,
                                rp_fused=rp, limit=limit,
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


def _p_func_bf16(inv: sym.HermSymbol):
    """The preconditioner of ``solver="mixed"``: ``h_block`` with the
    symbol and the block in bfloat16 on real and imaginary planes, the
    result cast back to the iterate's dtype (pcx/bandstructure.py:484-496;
    the reference's low-precision preconditioner, paper_2/lobpcg.py:
    494-629, with bfloat16 below a single-precision iterate)."""
    lo = torch.bfloat16
    d, sr, si = (a.to(lo) for a in (inv.diag, inv.sdiag.real,
                                    inv.sdiag.imag))
    rdt = inv.diag.dtype

    def p_func(v):
        yr, yi = h_block_planes(v.real.to(lo), v.imag.to(lo), d, sr, si)
        return torch.complex(yr.to(rdt), yi.to(rdt))

    return p_func


def eigen_1p(n: int, lattice: str, alpha, *, device,
             dtype: torch.dtype = torch.complex128,
             diel_type: str = TYPE_CHIRAL, nev: int = NEV, tol: float = TOL,
             maxiter: int = MAXITER, seed: int = 0,
             solver: str = "softlock", eps_opt: int = 0,
             verbose: bool = True, **solver_kw) -> EigenResult:
    """Single-k-point solve (reference: numerical_experiments.py:209-247).
    ``solver`` selects the variant: softlock, nolock, mixed, descent,
    davidson or jd (see ``KPointSolver``)."""
    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type, nev=nev,
                        eps_opt=eps_opt)
    kps = KPointSolver(cfg, device=device, dtype=dtype, tol=tol,
                       maxiter=maxiter, solver=solver, **solver_kw)
    result = kps.solve(np.asarray(alpha, dtype=float), seed=seed,
                       verbose=verbose)
    if verbose:
        print(f"n = {n}, lattice: {lattice}, "
              f"alpha/pi = {np.asarray(alpha) / np.pi}, "
              f"iter = {result.iterations}, "
              f"runtime = {result.wall_time:<6.3f}s, status = {result.status}")
    return result


# What a broken CUDA context or an exhausted card raises: cudaError_t codes
# of the kernels (kernels/_build.check) and the runtime's, cuBLAS and cuFFT
# status failures.
_DEVICE_ERROR_TAGS = ("CUDA error", "cudaError_t", "CUBLAS_STATUS", "cuFFT")


def _is_device_error(e: BaseException) -> bool:
    """True for device / infrastructure faults, after which every later
    solve would fail too (pcx bandstructure.py:1752-1756 matches XLA's
    strings; these are the CUDA counterparts)."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return any(tag in msg for tag in _DEVICE_ERROR_TAGS)


def bandgap(n: int, lattice: str, diel_type: str = TYPE_CHIRAL,
            eps_opt: int = 0, output_dir: str = "output",
            indices: Optional[list] = None, gap: int = GAP,
            dtype: torch.dtype = torch.complex128, tol: float = TOL,
            maxiter: int = MAXITER, nev: int = NEV, seed: int = 0,
            verbose: bool = True, metrics_path: Optional[str] = None,
            solver_opts: Optional[dict] = None,
            solver_kw: Optional[dict] = None, *,
            device="cuda") -> list:
    """Full Brillouin-zone band sweep with per-k-point JSON checkpointing,
    resume, warm starts and failure containment; returns the list of failed
    indices.

    Port of ``pcx.bandstructure.bandgap`` (reference: bandgap,
    numerical_experiments.py:313-496) with the same signature and library
    schema, except: ``device`` (default ``"cuda"``) and a torch ``dtype``;
    no ``k_batch``/``mesh`` (the sweep is serial on one device).
    ``solver_opts`` is the JAX package's dict (e.g.
    ``{"rr_gram": "pallas"}``); ``solver_kw`` goes to ``KPointSolver``
    (e.g. ``{"solver": "nolock"}``).
    """
    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type,
                        eps_opt=eps_opt, nev=nev)
    solver = KPointSolver(cfg, device=device, dtype=dtype,
                          tol=tol / cfg.scal ** 2, maxiter=maxiter,
                          solver_opts=solver_opts, **(solver_kw or {}))
    alphas = lattices.k_path(lattice, gap=gap)
    n_k = alphas.shape[0]

    suffix = str(eps_opt) if eps_opt else ""
    path = f"{output_dir}/{diel_type}/bandgap_{lattice}{suffix}.json"
    lib = BandLibrary(path, lattice, n, n_k, nev)
    logger = RunLogger(metrics_path, echo=False)

    if indices is None:
        pending = lib.pending_indices()
        indices = pending if len(pending) < n_k else list(range(n_k))
        if not indices:
            if verbose:
                print(f"{GREEN}All indices of {diel_type},{lattice} have "
                      f"been computed without errors.{RESET}")
            return []

    err_index = []
    x_prev = None
    prev_idx = None

    # Rows that already failed on a previous run get a fresh per-run seed
    # salt, so that a numerically deterministic failure does not repeat
    # identically on every resume (pcx bandstructure.py:1640-1651).
    failed_before = set(lib.failed_indices())
    salt = 0
    if failed_before:
        salt = int(np.random.SeedSequence().entropy % 100003) or 1
        if verbose:
            print(f"{YELLOW}{len(failed_before)} previously-failed rows "
                  f"will retry with seed salt {salt}{RESET}")

    def _seed_for(i):
        return seed + i + (salt if i in failed_before else 0)

    def _accept(result):
        """Raise unless the solve is acceptable: CONVERGED or FLOOR (or
        MAXITER with a passing validation), not spurious, and every tracked
        band's frequency-error bound res * scal^2 / (8 pi^2 omega) within
        2e-3 (pcx bandstructure.py:1656-1698).  Every port solve validates
        with the complex128 refine, so pcx's ``_accept_or_escalate``, which
        only escalates a "light" (working-precision) refine, is this."""
        stats = (f" [status={Status(result.status).name} "
                 f"iters={result.iterations} wall={result.wall_time:.1f}s]")
        ok = result.status in (Status.CONVERGED, Status.FLOOR)
        if (not ok and result.status == Status.MAXITER
                and result.report is not None
                and not result.report.spurious):
            ok = True
        if not ok:
            raise RuntimeError(
                f"solver status {Status(result.status).name}{stats}")
        if result.report is not None and result.report.spurious:
            raise RuntimeError(f"spurious eigenvalues{stats}")
        rep = result.report
        if rep is not None and rep.residuals is not None:
            om = np.maximum(np.asarray(rep.omega_re, float), 0.05)
            bound = (np.asarray(rep.residuals, float)[: len(om)]
                     * cfg.scal ** 2 / (8.0 * np.pi ** 2 * om))
            if float(np.max(bound)) > 2e-3:
                b = float(np.max(bound))
                raise RuntimeError(
                    f"under-converged: frequency-error bound {b:.2e} "
                    f"(band {int(np.argmax(bound))}; subspace likely "
                    f"missing a near-degenerate direction){stats}")

    last_commit_t = [time.time()]

    def _commit(i, result):
        nonlocal x_prev, prev_idx
        lib.record(i, result.iterations, result.wall_time, result.omega_re)
        logger.log_solve(RunLogger.from_result("bandgap_k", cfg,
                                               alphas[i], result))
        x_prev, prev_idx = result.x, i
        if verbose:
            now = time.time()
            print(f"Gap {i + 1}/{n_k} ({lattice}), "
                  f"alpha/pi = {np.round(alphas[i] / np.pi, 3)}: "
                  f"iters = {result.iterations}, "
                  f"t = {result.wall_time:<6.2f}s, "
                  f"wall = {now - last_commit_t[0]:.1f}s")
            last_commit_t[0] = now

    for i in indices:
        try:
            warm = (x_prev is not None and prev_idx is not None
                    and abs(i - prev_idx) <= 1)
            if not warm and i in failed_before:
                # Warm-feeder retry: re-solve an already computed neighbour
                # (not recorded: its row stays untouched) and warm-start
                # the failed row from its subspace, since cold starts are
                # how it failed before (pcx bandstructure.py:1782-1816).
                done = {k for k, rec in enumerate(lib.iterations)
                        if rec[0] > 0}
                for j in (i + 1, i - 1):
                    if 0 <= j < n_k and j in done:
                        try:
                            feeder = solver.solve(alphas[j], x0=None,
                                                  seed=_seed_for(i),
                                                  verbose=False)
                        except Exception as e:  # noqa: BLE001
                            if _is_device_error(e):
                                raise
                            continue   # try the other computed neighbour
                        if verbose:
                            print(f"{YELLOW}k={i}: warm-feeder solve of "
                                  f"computed neighbor k={j} "
                                  f"({feeder.iterations} iters){RESET}")
                        x_prev, prev_idx = feeder.x, j
                        warm = True
                        break
            retry_cold = False
            try:
                result = solver.solve(alphas[i],
                                      x0=(x_prev if warm else None),
                                      seed=_seed_for(i), verbose=False)
                _accept(result)
            except Exception as e:
                # One cold retry of a failed warm solve.  It runs after this
                # handler exits: inside it the live traceback pins the
                # failed solve's device blocks (pcx bandstructure.py:
                # 1817-1845).
                if not warm or _is_device_error(e):
                    raise
                print(f"{YELLOW}Warm-started k={i} failed ({e}); "
                      f"retrying with a cold start{RESET}")
                retry_cold = True
            if retry_cold:
                x_prev = None   # free the warm block before re-solving
                result = solver.solve(alphas[i], x0=None,
                                      seed=_seed_for(i) + 10007,
                                      verbose=False)
                _accept(result)
            _commit(i, result)
        except Exception as e:   # NaN, blow-up, spurious, RR failure
            # Numerical failures are recorded as [-1,-1] and the sweep goes
            # on; a device fault aborts it, since every later solve would
            # fail too and mass-fail the library (resume retries).
            if _is_device_error(e):
                print(f"{RED}DEVICE ERROR at k-point {i}: {e} — aborting "
                      f"sweep (resume will retry){RESET}")
                raise
            print(f"{RED}WARNING: Error at k-point {i}: {e}{RESET}")
            err_index.append(i)
            lib.record(i, -1, -1, None)
            x_prev, prev_idx = None, None

    if err_index:
        print(f"{RED}Error occurs at indices: {err_index}{RESET}")
    elif verbose:
        print(f"{GREEN}All indices computed correctly.{RESET}")
    return err_index


def _open_library(path: str, lattice: str, n: int, gap=None):
    """Open an existing band library and its k-path.  ``gap`` (points per
    path segment) is inferred from the library's row count when not given,
    so a library swept with a non-default gap reopens at its own k-path
    (pcx bandstructure.py:1872-1894)."""
    n_seg = lattices.sym_points(lattice).shape[0] - 1
    if gap is None:
        gap = GAP
        if os.path.exists(path):
            with open(path) as f:
                rows = json.load(f).get(f"{lattice}_{n}_iterations")
            if rows is not None:
                if len(rows) % n_seg:
                    raise ValueError(
                        f"{path}: {len(rows)} rows is not a multiple of "
                        f"{n_seg} path segments for {lattice!r}")
                gap = len(rows) // n_seg
    alphas = lattices.k_path(lattice, gap=gap)
    return BandLibrary(path, lattice, n, alphas.shape[0], NEV), alphas
