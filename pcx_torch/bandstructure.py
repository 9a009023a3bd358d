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
forms runs kernel K3 (any dtype); with ``solver_opts={"w_cap": ...}`` the
W apply runs K2 at the capped width (``lobpcg_sep_rs``).  On CPU tensors
the wrappers take their plain PyTorch versions.  The refine runs in
complex128 with torch.fft, as the JAX refine runs its f64 pair operator
with XLA products;
``refine="light"`` validates in the iterate's dtype through the three-pass
DFT (K2), with complex128-accumulated Grams.

``KPointSolver`` takes every keyword of the JAX package's constructor:
``refine``, ``x0_mode`` (plane-wave, random or two-grid cold starts),
``fft_mode`` and ``solver_impl`` (the complex LOBPCG family of
``solvers.lobpcg``) mean what they mean there; the TPU-only
``real_boundary``, ``apply_chunk`` and ``segment_iters`` are refused.
``bandgap_wnk_check`` and ``bandgap_history_check`` read a band library.

Several cards: ``KPointSolver.solve_batch(mesh=)`` and ``bandgap(mesh=)``
spread groups of k-points over the "k" axis of a ``pcx_torch.parallel``
mesh, one process per card (``torch.distributed``); ``bandgap(k_batch=)``
groups them on one card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from pcx_torch import interop, lattices, tracing, validate
from pcx_torch.config import (GAP, MAXITER, NEV, TOL, TYPE_CHIRAL,
                              ProblemConfig, block_width, set_relaxation)
from pcx_torch.io import BandLibrary
from pcx_torch.kernels.resid_precond import resid_precond
from pcx_torch.operators import maxwell
from pcx_torch.operators import symbols as sym
from pcx_torch.operators.blocks import h_block, h_block_planes
from pcx_torch.operators.dft import dft_mats, resample3, upsample_mat
from pcx_torch.operators import dielectric as diel_mod
from pcx_torch.parallel.mesh import GRID_AXIS, K_AXIS, axis_size
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.solvers.davidson import davidson_sep, jd_sep
from pcx_torch.solvers.lobpcg import (Status, lobpcg_sep_lanes,
                                      lobpcg_sep_mixedprecision_lanes)
from pcx_torch.solvers.lobpcg_rs import lobpcg_sep_rs, lobpcg_sep_rs_lanes
from pcx_torch.metrics import RunLogger
from pcx_torch.utils import (GREEN, RED, RESET, YELLOW, dots, generator,
                             norms, real_dtype, sqrt_robust)

SOLVER_OPTS = ("ortho_passes", "refresh_every", "floor_patience",
               "maxstagniter", "col_patience", "lam_tol", "lam_patience",
               "lam_res_tol", "rr_gram", "use_p", "w_cap", "subspace")
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
LOBPCG_ONLY_OPTS = ("rr_gram", "w_cap", "col_patience", "lam_tol",
                    "lam_patience", "lam_res_tol")

# Doom-check marks of a warm solve: the first at 24 iterations, then every
# 40 (the JAX segmented solve's boundaries, bandstructure.py:1469-1503).
# Every solve of the pair-layout route touches the heartbeat file there.
DOOM_FIRST, DOOM_EVERY = 24, 40

# The complex64 period of the H X / H P refresh at |alpha| >= 1 (and at
# Gamma), where the penalty weight is PNT_FAR = 4 pi^2.
REFRESH_EVERY, PNT_FAR = 8, 4.0 * np.pi ** 2


def refresh_period(pnt: float, period: int = REFRESH_EVERY) -> int:
    """The complex64 refresh period of a k-point with penalty weight
    ``pnt``.  Between refreshes the solver carries H X and H P through the
    Rayleigh-Ritz mixes, whose complex64 rounding grows with the operator's
    norm, about pnt |D|^2.  Near Gamma pnt = (2 pi / |alpha|)^2 exceeds
    PNT_FAR by up to 40x (k_path index 0), and with the period of |alpha|
    >= 1 a cold solve there drifts off its best point and runs to maxiter
    (ROADMAP F2).  The period shrinks by PNT_FAR / pnt, so that the drift
    per period stays what it is at |alpha| >= 1.  A port-only rule: the
    JAX solver keeps 8 everywhere."""
    if pnt <= PNT_FAR:
        return period
    return max(1, int(period * PNT_FAR / pnt))


# Values of the JAX constructor's keywords (pcx/bandstructure.py:171-352).
X0_MODES = ("plane_wave", "random", "coarse")
FFT_MODES = ("auto", "fft", "matmul")
SOLVER_IMPLS = ("auto", "rs", "complex")
REFINES = (None, True, False, "f64", "light")
# Keywords of the JAX constructor that exist only to work around the TPU
# backend (the real-boundary encoding, column-chunked applies, segmented
# programs): refused, see ROADMAP.md "Do not port".
TPU_ONLY = ("real_boundary", "apply_chunk", "segment_iters")


def _heartbeat() -> None:
    """Touch the liveness file named by $PCX_HEARTBEAT, if set, so that a
    supervisor (``pcx_torch.supervisor``) tells a solve that iterates from
    a hung worker: the library file advances once per k-point only (pcx
    bandstructure._heartbeat)."""
    path = os.environ.get("PCX_HEARTBEAT")
    if not path:
        return
    try:
        with open(path, "a"):
            pass
        os.utime(path)
    except OSError:
        pass


@dataclasses.dataclass
class EigenResult:
    omega: np.ndarray            # penalized frequencies (nev,)
    omega_re: np.ndarray         # recomputed frequencies (nev,)
    lambdas: np.ndarray          # raw Ritz values (m,), shift included
    x: Optional[torch.Tensor]    # Ritz vectors (m, 3, N, N, N); None for
                                 # a member solve_batch(mesh=) left on the
                                 # rank that solved it
    iterations: int
    wall_time: float
    status: int
    report: Optional[validate.ValidationReport]
    widths: Optional[np.ndarray] = None   # W/P width of each iteration
                                          # (the production LOBPCG only)


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

    ``device`` (default ``"cuda"``) and ``dtype``: complex64 is the GPU
    production iterate (kernels K1 and K2), complex128 the CPU parity
    iterate.

    ``solver_opts`` is the dict the JAX package's KPointSolver takes: the
    solver's options (``SOLVER_OPTS``; ``rr_gram="pallas"`` forms the
    Rayleigh-Ritz Gram with kernel K3) and three keys popped here, as
    there: ``warm_maxiter`` (default 150) caps warm-started solves,
    ``doom_check`` (default True) bails a warm solve whose frequency-error
    bound stalls above ``doom_tol`` (default ``lam_res_tol``, else 1e-3);
    see pcx KPointSolver.__init__ for the measured rationale of both.
    ``w_cap`` (an int or ``"auto"``) caps the width of the W and P blocks
    of the production LOBPCG (``lobpcg_sep_rs``; refused by Davidson, JD,
    ``solver_impl="complex"`` and, below the block width or as
    ``"auto"``, by ``rr_gram="pallas"``); ``EigenResult.widths`` holds the
    width of each iteration.  ``"auto"`` picks its bucket every iteration,
    in ``solve``, ``solve_batch`` and ``bandgap`` alike: the JAX package's
    one-shot and batched programs ran it at full width, because one
    program has one width (pcx/bandstructure.py:159-164).
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

    The other keywords of the JAX constructor:

    * ``solver_impl``: ``"rs"`` (the default, ``"auto"``, on every device:
      the pair-layout route of the JAX accelerators, ``lobpcg_rs``) or
      ``"complex"``, the complex LOBPCG family of ``solvers.lobpcg``
      (softlock, nolock, mixed with a complex64 preconditioner, descent),
      the JAX default on the CPU; one solve with no warm cap and no doom
      check, and it refuses the pair-layout options ``LOBPCG_ONLY_OPTS``;
      ``solve_batch`` runs a group as lanes of ``lobpcg_sep_lanes``.
      Davidson and JD run ``solvers.davidson`` under either.
    * ``fft_mode``: the operator's DFT.  ``"matmul"`` (JAX's name) is the
      three-pass DFT of ``dft3`` (kernel K2, an FFT, in complex64), ``"fft"``
      torch.fft (cuFFT on the card); as in JAX the pair-layout route always
      takes the three-pass DFT, and ``"auto"`` takes it on the card and
      torch.fft on the CPU.
    * ``refine``: ``True``, ``"f64"`` or ``None`` (default) validate every
      solve by the complex128 Rayleigh-Ritz refine (``refine_stats``);
      ``"light"`` by the refine in the iterate's dtype with
      complex128-accumulated Grams (``refine_light_stats``); ``False`` by
      the Rayleigh quotients and residuals of the solver's own Ritz pairs
      (``stats``).  The JAX package runs ``"light"`` only in its
      real-boundary mode and takes ``False`` elsewhere; the port has no
      such mode, so ``"light"`` always means the light refine.
    * ``x0_mode``: the cold start.  ``"plane_wave"`` (default), ``"random"``
      (uniform real and imaginary parts from a ``torch.Generator`` seeded
      with the solve's seed: not the JAX bits), ``"coarse"`` or
      ``"coarse:<nc>"`` (nc default max(8, n // 2)): solve the k-point on
      the nc-grid, without validation, and lift the block by trigonometric
      interpolation (``dft.resample3``); its time counts in the fine
      solve's wall time (``last_x0_wall``).
    * ``real_boundary``, ``apply_chunk``, ``segment_iters``: TPU-only
      (``TPU_ONLY``), refused with ``ValueError`` unless None.
    """

    def __init__(self, cfg: ProblemConfig, *, device="cuda",
                 dtype: torch.dtype = torch.complex128,
                 tol: float = TOL, maxiter: int = MAXITER,
                 solver: str = "softlock",
                 solver_opts: Optional[dict] = None,
                 diel: Optional[diel_mod.DielectricOp] = None,
                 parts: Optional[sym.SymbolParts] = None,
                 refine=None, x0_mode: str = "plane_wave",
                 fft_mode: str = "auto", solver_impl: str = "auto",
                 real_boundary=None, apply_chunk=None, segment_iters=None):
        tpu_only = [k for k, v in zip(TPU_ONLY, (real_boundary, apply_chunk,
                                                 segment_iters))
                    if v is not None]
        if tpu_only:
            raise ValueError(
                f"KPointSolver keywords {tpu_only} work around the TPU "
                f"backend of pcx and are not ported (ROADMAP.md, "
                f"'Do not port')")
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        if dtype not in (torch.complex64, torch.complex128):
            raise ValueError(f"dtype must be complex64 or complex128, "
                             f"got {dtype}")
        self._coarse_n = None
        if isinstance(x0_mode, str) and x0_mode.startswith("coarse"):
            _, _, nc = x0_mode.partition(":")
            self._coarse_n = int(nc) if nc else max(8, cfg.n // 2)
            if self._coarse_n >= cfg.n:
                raise ValueError(f"coarse grid {self._coarse_n} must be "
                                 f"smaller than n={cfg.n}")
            x0_mode = "coarse"
        if x0_mode not in X0_MODES:
            raise ValueError(f"unknown x0_mode {x0_mode!r}")
        if fft_mode not in FFT_MODES:
            raise ValueError(f"unknown fft_mode {fft_mode!r}")
        if solver_impl not in SOLVER_IMPLS:
            raise ValueError(f"unknown solver_impl {solver_impl!r}")
        if refine not in REFINES:
            raise ValueError(f"unknown refine {refine!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.rdt = real_dtype(dtype)
        self.tol = tol
        self.maxiter = maxiter
        self.x0_mode = x0_mode
        self.fft_mode = fft_mode
        self.impl = "rs" if solver_impl == "auto" else solver_impl
        self.refine = "f64" if refine in (None, True, "f64") else refine
        self._user_opts = dict(solver_opts or {})
        opts = dict(self._user_opts)
        self.warm_maxiter = int(opts.pop("warm_maxiter", 150))
        self.doom_check = bool(opts.pop("doom_check", True))
        self.doom_tol = float(opts.pop("doom_tol",
                                       opts.get("lam_res_tol", 1e-3)))
        unknown = sorted(set(opts) - set(SOLVER_OPTS))
        if unknown:
            raise ValueError(f"unknown solver_opts {unknown}; supported: "
                             f"{SOLVER_OPTS + SOLVE_OPTS}")
        not_theirs = ((LOBPCG_ONLY_OPTS if solver in DAVIDSONS
                       or self.impl == "complex" else ())
                      + (() if solver in DAVIDSONS else ("subspace",)))
        refused = sorted(set(opts) & set(not_theirs))
        if refused:
            raise ValueError(f"solver_opts {refused} are not options of "
                             f"solver {solver!r} (solver_impl="
                             f"{self.impl!r})")
        ow = opts.get("w_cap")
        if ow is not None and not (ow == "auto" or (
                isinstance(ow, int) and not isinstance(ow, bool))):
            raise ValueError(f"solver_opts w_cap must be an int or 'auto', "
                             f"got {ow!r}")
        if ow == "auto" and opts.get("rr_gram") == "pallas":
            # an int cap below the block width fails at the solve, which
            # knows the width (pcx/bandstructure.py:654-660)
            raise ValueError("w_cap (incl. 'auto') is not supported with "
                             "rr_gram='pallas'")
        if dtype == torch.complex64:
            # complex64 robustness defaults of the JAX solver
            # (bandstructure.py:261-280): two orthogonalization passes,
            # HX/HP refresh every 8 iterations, FLOOR patience 6.
            opts.setdefault("ortho_passes", 2)
            opts.setdefault("refresh_every", REFRESH_EVERY)
            opts.setdefault("floor_patience", 6)
        # near Gamma the default refresh period shrinks (refresh_period)
        self._scale_refresh = (dtype == torch.complex64
                               and "refresh_every" not in self._user_opts
                               and solver not in DAVIDSONS)
        if solver == "descent":
            opts.setdefault("use_p", False)
        self.solver_opts = opts
        self.solver = solver
        self.locking = solver != "nolock"
        self.last_doom = None   # (it, worst bound) of the last doom bail
        self.last_x0_wall = 0.0   # seconds of the last coarse start
        ct = (lattices.ct_matrix(cfg.lattice) if cfg.lattice else np.eye(3))
        self.parts = parts if parts is not None else sym.symbol_parts(
            cfg.n, cfg.k, ct, cfg.scal, self.device)
        self.diel = diel if diel is not None else diel_mod.build(
            cfg.diel_type, cfg.n, cfg.lattice, self.device,
            eps_opt=cfg.eps_opt, k=cfg.k)
        # The three-pass DFT of the light refine, and of the solve unless it
        # takes torch.fft (pcx/bandstructure.py:327-333).
        self._mats = dft_mats(cfg.n, dtype, self.device)
        use_matmul = (fft_mode == "matmul" or self.impl == "rs"
                      or (fft_mode == "auto" and self.device.type != "cpu"))
        self.dft = self._mats if use_matmul else None
        self._coarse_cache = None

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

    @tracing.spanned("pcx.symbols")
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
        return generator(seed, self.device)

    def _coarse(self) -> "KPointSolver":
        """The coarse-grid twin of ``x0_mode="coarse"``, built at first use:
        the same lattice, dielectric type, solver and options on the
        nc-grid, with its own symbols and dielectric, no validation and a
        plane-wave start.  On the pair-layout route it stops once its Ritz
        values stop moving (lam_tol 1e-5, patience 2): the start's quality
        saturates there (pcx bandstructure._coarse)."""
        if self._coarse_cache is None:
            opts = dict(self._user_opts)
            if self.impl == "rs" and self.solver not in DAVIDSONS:
                opts.setdefault("lam_tol", 1e-5)
                opts.setdefault("lam_patience", 2)
            self._coarse_cache = KPointSolver(
                dataclasses.replace(self.cfg, n=self._coarse_n),
                device=self.device, dtype=self.dtype, tol=self.tol,
                maxiter=self.maxiter, solver=self.solver, solver_opts=opts,
                refine=False, x0_mode="plane_wave", fft_mode=self.fft_mode,
                solver_impl=self.impl)
        return self._coarse_cache

    def _x0_cold(self, alpha, m: int, seed: int) -> torch.Tensor:
        """Cold-start block by ``x0_mode``.  The plane-wave start: transverse
        plane waves at the m/2 lowest vacuum frequencies plus 1e-2 jitter
        from a generator seeded with ``seed`` (pcx maxwell.plane_wave_cols /
        plane_wave_scatter).  The two-grid start falls back to a random
        block when the coarse solve ends NAN or BLOWUP."""
        if self.x0_mode == "coarse":
            res = self._coarse().solve(alpha, seed=seed,
                                       validate_result=False)
            if res.status in (Status.NAN, Status.BLOWUP):
                return maxwell.random_block(self._generator(seed),
                                            self.cfg.n, m, self.dtype,
                                            self.device)
            u = torch.as_tensor(upsample_mat(self._coarse_n, self.cfg.n),
                                device=self.device).to(self.dtype)
            x = resample3(res.x, u)
            return x if x.shape[0] == m else self._fit(x, m, seed)
        if self.x0_mode == "random":
            return maxwell.random_block(self._generator(seed), self.cfg.n, m,
                                        self.dtype, self.device)
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

    def _lane_parts(self, alphas) -> tuple:
        """The k-dependent parts of a solve of the group ``alphas`` on a
        lane axis: (symbols, refresh periods; None where the solver's
        option or default holds).  ``symbols(lanes)`` gives, for a tuple of
        lane indices, the curl, penalty and inverse-penalty symbols (R, 1,
        3, N, N, N) and the shifts of those lanes, as a ``Symbols`` (its
        ``pnt`` unused).  A group of one keeps its symbols as views and its
        shift as the number; a larger group stacks them, the shifts as an
        (R, 1, 1, 1, 1, 1) tensor (0.0 when every lane's is 0, as the apply
        then skips it).  The subset of the lanes still running is selected
        once and kept until the running set changes."""
        per = [self.symbols_for(a) for a in alphas]
        shifts = [s.shift for s in per]
        refresh = ([refresh_period(s.pnt) for s in per]
                   if self._scale_refresh else None)
        full = tuple(_lane_axis(parts)[:, None] for parts in
                     zip(*((s.d_a, *s.b, *s.inv) for s in per)))
        del per

        def build(lanes: tuple) -> Symbols:
            parts = full
            if len(lanes) < len(shifts):
                idx = torch.as_tensor(lanes, device=self.device)
                parts = tuple(a.index_select(0, idx) for a in full)
            sh = [shifts[j] for j in lanes]
            if len(shifts) == 1:
                shift = sh[0]
            elif any(sh):
                shift = torch.tensor(sh, dtype=self.rdt, device=self.device
                                     ).view(-1, 1, 1, 1, 1, 1)
            else:
                shift = 0.0
            return Symbols(parts[0], sym.HermSymbol(parts[1], parts[2]),
                           sym.HermSymbol(parts[3], parts[4]), shift, 0.0)

        return _per_running(build), refresh

    @tracing.spanned("pcx.solve")
    def _solve_group(self, alphas, x0s, seeds, validate_result: bool,
                     verbose: bool, raise_on_spurious: bool) -> list:
        """Solve the k-points ``alphas`` as the lanes of one solve: the body
        of ``solve`` (a group of one) and of ``solve_batch``.  Member i
        starts from ``x0s[i]`` (fitted to the width) or cold with
        ``seeds[i]``.  ``solver_impl="rs"`` runs ``lobpcg_sep_rs_lanes``
        (``lobpcg_sep_rs``, its one-lane entry, for a group of one) with
        each member's warm cap and doom check; ``solver_impl="complex"``
        runs ``lobpcg_sep_lanes`` (``lobpcg_sep_mixedprecision_lanes`` for
        ``mixed``, its preconditioner cast to complex64) with no warm cap and
        no doom check, as the JAX complex route (pcx/bandstructure.py:
        441-456).  Davidson and JD take a group of one, through one-lane
        views of the hooks.  Every member is validated by ``refine``, and its
        ``wall_time`` is the group's over its size."""
        m = self.block_width(alphas[0])
        warm = x0s is not None
        t_x0 = time.time()
        if warm:
            blocks = [self._fit(x, m, sd) if x.shape[0] != m else x
                      for x, sd in zip(
                          (x.to(device=self.device, dtype=self.dtype)
                           for x in x0s), seeds)]
        else:
            blocks = [self._x0_cold(a, m, sd)
                      for a, sd in zip(alphas, seeds)]
        x0 = _lane_axis(blocks)
        del blocks
        x0_wall = 0.0
        if not warm and self.x0_mode == "coarse":
            # the two-grid start's coarse solve counts in the wall time
            # (time to validated frequencies from scratch)
            self._sync()
            x0_wall = time.time() - t_x0
        self.last_x0_wall = x0_wall

        self._sync()
        t0 = time.time()
        symbols, refresh = self._lane_parts(alphas)

        def h_func(v, lanes):
            sy = symbols(lanes)
            return maxwell.ama_bb(v, sy.d_a, sy.b, self.diel, sy.shift,
                                  self.dft)

        if self.solver == "mixed" and self.impl == "rs":
            bf16 = _per_running(lambda lanes: _p_func_bf16(
                symbols(lanes).inv))

            def p_func(v, lanes):
                return bf16(lanes)(v)
        else:
            def p_func(v, lanes):
                return h_block(v, symbols(lanes).inv)

        opts = dict(self.solver_opts)
        if refresh is not None:
            opts["refresh_every"] = refresh
        self.last_doom = None
        widths = [None for _ in alphas]

        def one(f):
            """A lane hook as the hook of a group of one (views)."""
            return lambda *a: _lane0(f(*(b[None] for b in a), (0,)))

        with tracing.span("pcx.lobpcg"):
            if self.solver in DAVIDSONS:
                fn = davidson_sep if self.solver == "davidson" else jd_sep
                kw = {k: v for k, v in opts.items() if k == "subspace"}
                res = [fn(one(h_func), one(p_func), x0[0], self.cfg.nev,
                          tol=self.tol, maxiter=self.maxiter, **kw)]
            elif self.impl == "complex":
                fn = (lobpcg_sep_mixedprecision_lanes
                      if self.solver == "mixed" else lobpcg_sep_lanes)
                res = fn(h_func, p_func, x0, self.cfg.nev, tol=self.tol,
                         maxiter=self.maxiter, locking=self.locking, **opts)
            else:
                # K1 computes the preconditioner in float32: off for "mixed"
                rp = (self._k1_hook(symbols, m)
                      if self.dtype == torch.complex64
                      and self.solver != "mixed" else None)
                limit = (min(self.maxiter, self.warm_maxiter)
                         if warm and self.warm_maxiter > 0 else None)
                widths = [[] for _ in alphas]
                monitors = [self._monitor(warm) for _ in alphas]
                kw = dict(tol=self.tol, maxiter=self.maxiter,
                          locking=self.locking, limit=limit)
                if len(alphas) == 1:
                    # the library's one-lane entry, which is the lane body
                    # at one lane: the same launches on views
                    if refresh is not None:
                        opts["refresh_every"] = refresh[0]
                    res = [lobpcg_sep_rs(
                        one(h_func), one(p_func), x0[0], self.cfg.nev,
                        rp_fused=None if rp is None else one(rp),
                        monitor=monitors[0], widths=widths[0], **kw, **opts)]
                else:
                    res = lobpcg_sep_rs_lanes(
                        h_func, p_func, x0, self.cfg.nev, rp_fused=rp,
                        monitor=monitors, widths=widths, **kw, **opts)
        del x0
        self._sync()
        wall = (time.time() - t0 + x0_wall) / len(alphas)
        _heartbeat()
        return [self._result(a, r, wall, w, validate_result, verbose,
                             raise_on_spurious)
                for a, r, w in zip(alphas, res, widths)]

    def _k1_hook(self, symbols, m: int):
        """The rp_fused hook of the solver: kernel K1 on the flat (R, m,
        3N^3) blocks of the running lanes."""
        n3 = self.cfg.n ** 3

        def rp(xf, hxf, lam, lanes):
            inv = symbols(lanes).inv
            r = len(lanes)
            w, sumsq = resid_precond(
                xf.view(r, m, 3, n3), hxf.view(r, m, 3, n3), lam,
                inv.diag.view(r, 3, n3), inv.sdiag.view(r, 3, n3))
            return w.view(r, m, -1), sumsq

        return rp

    def _doom(self):
        """Host-side doom check of a warm solve, called at the marks 24, 64,
        104, ...: bail (status MAXITER) when the frequency-error
        admissibility bound res_i / (doom_tol 4 pi sqrt(max(|lambda_i|,
        1))) of a tracked column exceeds 10, or exceeds 1 while improving
        < 15% since the previous mark (pcx bandstructure.py:238-258,
        1486-1503)."""
        nev = self.cfg.nev
        prev = [None]

        def doomed(it, res, lambdas):
            tracing.count("sync.doom")
            lam = np.abs(lambdas[:nev].cpu().numpy())
            cap = self.doom_tol * 4.0 * np.pi * np.sqrt(np.maximum(lam, 1.0))
            with np.errstate(invalid="ignore"):
                viol = res[:nev] / cap
            worst = float(np.nanmax(viol)) if viol.size else 0.0
            if worst > 10.0 or (prev[0] is not None and worst > 1.0
                                and worst > 0.85 * prev[0]):
                self.last_doom = (it, worst * self.doom_tol)
                return True
            prev[0] = worst
            return False

        return doomed

    def _monitor(self, warm: bool):
        """The solver's per-iteration hook: at the doom-check marks it
        touches the heartbeat (no device read) and, on a warm solve with
        ``doom_check``, runs the doom check."""
        doomed = self._doom() if warm and self.doom_check else None

        def monitor(it, res, lambdas):
            if it < DOOM_FIRST or (it - DOOM_FIRST) % DOOM_EVERY:
                return False
            _heartbeat()
            return doomed is not None and doomed(it, res, lambdas)

        return monitor

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve(self, alpha, x0: Optional[torch.Tensor] = None, seed: int = 0,
              validate_result: bool = True, verbose: bool = False,
              raise_on_spurious: bool = True) -> EigenResult:
        """Solve one k-point from ``x0`` (warm) or a cold start by
        ``x0_mode``, and validate it by ``refine``.  ``raise_on_spurious``
        (default True, as in JAX) raises ``SpuriousModeError`` from the
        validation; False leaves the verdict in ``report.spurious``."""
        res, = self._solve_group([np.asarray(alpha, dtype=float)],
                                 None if x0 is None else [x0], [seed],
                                 validate_result, verbose, raise_on_spurious)
        return res

    def _result(self, alpha, res, wall: float, widths, validate_result: bool,
                verbose: bool, raise_on_spurious: bool) -> EigenResult:
        """The ``EigenResult`` of a solver result at ``alpha``, validated by
        ``refine`` when ``validate_result`` and the status allows."""
        cfg = self.cfg
        tracing.count("sync.result")
        lambdas = res.lambdas.cpu().numpy().astype(float)
        status = res.status
        report = None
        omega = omega_re = None
        if status in (Status.CONVERGED, Status.FLOOR, Status.MAXITER):
            if validate_result and self.refine:
                report, lambdas = self._refine_report(
                    alpha, res.x, verbose=verbose,
                    raise_on_spurious=raise_on_spurious)
                omega, omega_re = report.omega_pnt, report.omega_re
            elif validate_result:
                report = self._stats_report(
                    alpha, res.x, lambdas, verbose=verbose,
                    raise_on_spurious=raise_on_spurious)
                omega, omega_re = report.omega_pnt, report.omega_re
            else:
                shift, _ = _shift_pnt(alpha, cfg.scal)
                lam = lambdas[:cfg.nev] - (shift if shift > 0 else 0.0)
                omega = np.array([sqrt_robust(v) * cfg.scal / (2 * np.pi)
                                  for v in lam])
                omega_re = omega
        return EigenResult(omega=omega, omega_re=omega_re, lambdas=lambdas,
                           x=res.x, iterations=res.iterations,
                           wall_time=wall, status=status, report=report,
                           widths=(None if widths is None
                                   else np.asarray(widths, np.int64)))

    @tracing.spanned("pcx.refine")
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
        tracing.count("sync.refine", 3)
        return (theta.cpu().numpy(), lam_re.cpu().numpy(),
                res.cpu().numpy())

    @tracing.spanned("pcx.refine")
    def refine_light_stats(self, alpha, x: torch.Tensor):
        """The light refine (``refine="light"``; pcx ``_refine_light_jit``):
        ``refine_stats`` with the operator applied in the iterate's dtype
        through the three-pass DFT (kernel K2 in complex64), one full-width
        ``ama_bb`` and one ``ama`` on the leading nev Ritz vectors, the
        projected pencil and the quotients accumulated in complex128
        (``rr.gram_f64``) and solved in complex128.  Returns (theta (m,),
        lam_re (nev,), res (nev,)) as numpy, theta with the shift
        included."""
        cfg, nev = self.cfg, self.cfg.nev
        shift, pnt = _shift_pnt(alpha, cfg.scal)
        d_a64 = sym.build_curl(self.parts, alpha)
        d_a = d_a64.to(self.dtype)
        b = sym.penalty(d_a64, pnt).to(self.dtype)
        del d_a64
        m = x.shape[0]
        xw = x.to(self.dtype)
        xf = xw.reshape(m, -1)
        hx = maxwell.ama_bb(xw, d_a, b, self.diel, shift, self._mats)
        t = rr.gram_f64(xf, hx.reshape(m, -1))
        del hx
        theta, c = rr.pencil_eigh(t, rr.gram_f64(xf, xf))
        y = rr.mix(c[:, :nev].to(self.dtype), xf)
        ay = maxwell.ama(y.view((nev,) + x.shape[1:]), d_a, self.diel,
                         self._mats).reshape(nev, -1)

        def diag_f64(a, b_):
            return rr.gram_f64(a, b_).diagonal().real

        den = diag_f64(y, y).clamp(min=1e-30)
        lam_re = diag_f64(y, ay) / den
        r = ay - (theta[:nev] - shift).to(self.rdt)[:, None] * y
        res = (diag_f64(r, r) / den).sqrt()
        tracing.count("sync.refine", 3)
        return (theta.cpu().numpy(), lam_re.cpu().numpy(),
                res.cpu().numpy())

    def _refine_report(self, alpha, x, verbose=False,
                       raise_on_spurious=True, mode=None):
        """(report, theta) of the refine named by ``mode`` (default
        ``self.refine``: ``"f64"`` or ``"light"``); the sweep escalates a
        light refine's rejection to ``mode="f64"``."""
        mode = self.refine if mode is None else mode
        refine = (self.refine_light_stats if mode == "light"
                  else self.refine_stats)
        theta, lam_re, res = refine(alpha, x)
        shift, _ = _shift_pnt(alpha, self.cfg.scal)
        report = validate.recompute(
            theta[:self.cfg.nev], shift=shift, scal=self.cfg.scal,
            stats=(lam_re, res), verbose=verbose,
            raise_on_spurious=raise_on_spurious)
        return report, theta

    def stats(self, alpha, x: torch.Tensor, lambdas):
        """Validation statistics of ``refine=False``: the Rayleigh quotients
        of the leading nev Ritz vectors against the unpenalized operator and
        their residual norms against the solver's penalized Ritz values
        ``lambdas`` (shift included), in the iterate's dtype with the
        solve's DFT (pcx ``stats_core``).  Returns (lam_re, res) as numpy."""
        nev = self.cfg.nev
        sy = self.symbols_for(alpha)
        xs = x[:nev].to(self.dtype)
        ax = maxwell.ama(xs, sy.d_a, self.diel, self.dft)
        lam_re = (dots(xs, ax) / dots(xs, xs)).real
        lam_pen = np.asarray(lambdas, float)[:nev] - (
            sy.shift if sy.shift > 0 else 0.0)
        lam_pen = torch.as_tensor(lam_pen, device=self.device).to(self.rdt)
        res = norms(ax - lam_pen.reshape((-1,) + (1,) * (xs.dim() - 1)) * xs)
        return lam_re.cpu().numpy(), res.cpu().numpy()

    def _stats_report(self, alpha, x, lambdas, verbose=False,
                      raise_on_spurious=True):
        shift, _ = _shift_pnt(alpha, self.cfg.scal)
        return validate.recompute(
            np.asarray(lambdas, float)[:self.cfg.nev], shift=shift,
            scal=self.cfg.scal, stats=self.stats(alpha, x, lambdas),
            verbose=verbose, raise_on_spurious=raise_on_spurious)

    def validate_solution(self, alpha, result: EigenResult,
                          verbose: bool = False,
                          raise_on_spurious: bool = True):
        """Validation report for an existing solve at ``alpha`` (no
        re-solve), by ``refine``."""
        alpha = np.asarray(alpha, dtype=float)
        if self.refine:
            return self._refine_report(alpha, result.x, verbose=verbose,
                                       raise_on_spurious=raise_on_spurious)[0]
        return self._stats_report(alpha, result.x, result.lambdas,
                                  verbose=verbose,
                                  raise_on_spurious=raise_on_spurious)

    def solve_batch(self, alphas, x0s=None, seed: int = 0,
                    validate_result: bool = True, mesh=None,
                    raise_on_spurious: bool = True) -> list:
        """Solve a group of k-points that share one block width (true along
        a path), as ``pcx.bandstructure.KPointSolver.solve_batch``: member i
        starts from ``x0s[i]`` (a list of blocks, fitted to the width, or a
        stacked tensor) or cold with seed ``seed + i``, and every member's
        ``wall_time`` is the group's wall time over its size.  A batch that
        mixes block widths raises ``ValueError``.

        Without ``mesh`` the LOBPCG solvers (softlock, nolock, descent,
        mixed) solve the members in lockstep on this solver's device, as
        JAX's vmapped ``_jitted_batch_rs`` and ``_jitted_batch`` do: one
        lane-batched solve, each lane computing what its serial solve
        computes, through the driver of ``solve``: ``solver_impl="rs"``
        runs ``lobpcg_sep_rs_lanes`` (kernels K1, K2 and K3 over every
        lane) with each solve's warm cap and doom check;
        ``solver_impl="complex"`` runs ``lobpcg_sep_lanes`` (K2 over every
        lane's columns in complex64).
        Davidson and JD solve the members one after another by ``solve``
        (JAX's batch programs run LOBPCG whatever the solver's name, which
        is not ported).  A group that does not fit in device memory
        raises.

        ``mesh``: a ``pcx_torch.parallel`` mesh; every rank calls with the
        same arguments.  The group is padded to a multiple of the "k" axis
        by repeating its last member (a padding copy is not solved: it
        would repeat its original) and k row r solves and validates its
        contiguous slice, as JAX's ``P("k")`` spec places it, in lockstep
        as above; the ranks of
        a row's grid axis solve the same members, and its grid rank 0
        supplies the results.  Every rank returns the group's results:
        frequencies, Ritz values, iterations, status, wall time and
        validation report are gathered to all ranks, while a member's
        ``x`` stays on the ranks that solved it (None elsewhere), except
        the last member's, which is broadcast to every rank: the sweep
        warm-starts its next group from it.  The group's wall time is its
        slowest row's.  A member that raises makes the whole group raise
        the same error on every rank."""
        alphas = [np.asarray(a, dtype=float) for a in alphas]
        n_req = len(alphas)
        n_k = 1 if mesh is None else axis_size(mesh, K_AXIS)
        pad = (-n_req) % n_k
        if pad:
            if not isinstance(x0s, (list, tuple, type(None))):
                raise ValueError(
                    "x0s must be a list/tuple (not a pre-stacked tensor) "
                    "when a mesh group needs padding — pass one block per "
                    "k-point")
            alphas = alphas + [alphas[-1]] * pad
        ms = {self.block_width(a) for a in alphas}
        if len(ms) != 1:
            raise ValueError(f"batch mixes block widths {ms}")
        m = ms.pop()
        if x0s is not None and len(x0s) < n_req:
            raise ValueError(f"{len(x0s)} start blocks for {n_req} k-points")

        def run(lo, hi):
            """Members lo..hi-1, as solve_batch returns them."""
            if self.solver not in DAVIDSONS:
                return self._solve_group(
                    alphas[lo:hi], None if x0s is None else x0s[lo:hi],
                    [seed + i for i in range(lo, hi)], validate_result,
                    False, raise_on_spurious)
            out = [self.solve(alphas[i], x0=None if x0s is None else x0s[i],
                              seed=seed + i, validate_result=validate_result,
                              raise_on_spurious=raise_on_spurious)
                   for i in range(lo, hi)]
            wall = sum(r.wall_time for r in out)
            return [dataclasses.replace(r, wall_time=wall / len(out))
                    for r in out]

        if mesh is None:
            return run(0, n_req)

        per = len(alphas) // n_k
        row = mesh.get_local_rank(K_AXIS)
        lead = mesh.get_local_rank(GRID_AXIS) == 0
        results, errors, wall = {}, {}, 0.0
        lo, hi = row * per, min((row + 1) * per, n_req)
        if lo < hi:
            try:
                results = dict(zip(range(lo, hi), run(lo, hi)))
            except Exception as e:  # noqa: BLE001  every rank must reach
                errors[lo] = e      # the gather, which re-raises it
            wall = sum(r.wall_time for r in results.values())
        mine = ({i: dataclasses.replace(r, x=None)
                 for i, r in results.items()} if lead else {}, errors, wall)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        recs, errs = {}, {}
        for got_recs, got_errs, _ in gathered:
            recs.update(got_recs)
            errs.update(got_errs)
        if errs:
            raise errs[min(errs)]
        wall = max(w for _, _, w in gathered)

        last = n_req - 1
        src = _member_rank(mesh, n_req, last)
        if dist.get_rank() == src:
            x_last = results[last].x.contiguous()
        else:
            x_last = torch.empty((m, 3) + (self.cfg.n,) * 3, dtype=self.dtype,
                                 device=self.device)
        dist.broadcast(torch.view_as_real(x_last), src=src)
        return [dataclasses.replace(
            recs[i], wall_time=wall / n_req,
            x=(x_last if i == last
               else results[i].x if i in results else None))
            for i in range(n_req)]


def _member_rank(mesh, n_req: int, j: int) -> int:
    """The global rank that supplies member ``j`` of a ``solve_batch`` group
    of ``n_req`` k-points on ``mesh``: grid rank 0 of the k row whose slice
    of the padded group holds it."""
    n_k = axis_size(mesh, K_AXIS)
    per = -(-n_req // n_k)
    return int(mesh.mesh[j // per, 0])


def _lane_axis(parts) -> torch.Tensor:
    """The tensors ``parts`` on a leading lane axis: a view of the one
    tensor of a group of one (stacking would copy it), else their stack."""
    return parts[0][None] if len(parts) == 1 else torch.stack(parts)


def _lane0(out):
    """The one lane of a hook's output: a tensor or a tuple of them."""
    return tuple(a[0] for a in out) if isinstance(out, tuple) else out[0]


def _per_running(build):
    """``build(lanes)`` for a tuple of running lanes, kept until the set of
    running lanes changes."""
    cache = {}

    def get(lanes: tuple):
        if lanes not in cache:
            cache.clear()
            cache[lanes] = build(lanes)
        return cache[lanes]

    return get


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


def eigen_1p(n: int, lattice: str, alpha, *, device="cuda",
             dtype: torch.dtype = torch.complex128,
             diel_type: str = TYPE_CHIRAL, nev: int = NEV, tol: float = TOL,
             maxiter: int = MAXITER, seed: int = 0,
             solver: str = "softlock", eps_opt: int = 0,
             verbose: bool = True, **solver_kw) -> EigenResult:
    """Single-k-point solve (reference: numerical_experiments.py:209-247),
    on the card unless ``device`` says otherwise.  ``solver`` selects the
    variant: softlock, nolock, mixed, descent, davidson or jd; ``solver_kw``
    takes the other ``KPointSolver`` keywords (``refine``, ``x0_mode``,
    ...)."""
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
            k_batch: int = 1, solver_opts: Optional[dict] = None,
            solver_kw: Optional[dict] = None, mesh=None, *,
            device="cuda") -> list:
    """Full Brillouin-zone band sweep with per-k-point JSON checkpointing,
    resume, warm starts and failure containment; returns the list of failed
    indices.

    Port of ``pcx.bandstructure.bandgap`` (reference: bandgap,
    numerical_experiments.py:313-496) with the same signature and library
    schema, and ``device`` (default ``"cuda"``) and a torch ``dtype``.
    ``solver_opts`` is the JAX package's dict (e.g.
    ``{"rr_gram": "pallas"}``); ``solver_kw`` goes to ``KPointSolver``
    (e.g. ``{"solver": "nolock"}`` or ``{"refine": "light"}``, the
    production runner's default: a rejection by the light refine is
    re-validated by the complex128 refine before the cold retry).

    ``k_batch`` > 1 solves consecutive groups of that many indices through
    ``KPointSolver.solve_batch``; every member of a group warm-starts from
    the last committed block when the group begins next to its index, and
    a group that fails records each member not yet committed as failed.
    ``mesh`` (a ``pcx_torch.parallel`` mesh; ``k_batch`` then defaults to
    its "k" axis) spreads each group over the k axis, one member slice per
    k row.  Every rank of the mesh calls ``bandgap`` with the same
    arguments and keeps the same library in memory, so that pending rows,
    warm starts and acceptance agree; rank 0 alone writes the library and
    the metrics file and prints.  The seed salt of retried rows is drawn
    on rank 0 and broadcast.  A light-refine rejection of a member is
    re-validated by the rank that holds its block, and the verdict
    broadcast.
    """
    if mesh is not None and k_batch <= 1:
        k_batch = axis_size(mesh, K_AXIS)
    rank = 0 if mesh is None else dist.get_rank()

    def say(*args, **kw):
        if rank == 0:
            print(*args, **kw)

    def from_rank0(obj):
        if mesh is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type,
                        eps_opt=eps_opt, nev=nev)
    solver = KPointSolver(cfg, device=device, dtype=dtype,
                          tol=tol / cfg.scal ** 2, maxiter=maxiter,
                          solver_opts=solver_opts, **(solver_kw or {}))
    alphas = lattices.k_path(lattice, gap=gap)
    n_k = alphas.shape[0]

    path = _library_path(output_dir, diel_type, lattice, eps_opt)
    lib = BandLibrary(path, lattice, n, n_k, nev) if rank == 0 else None
    if mesh is not None:   # every rank holds rank 0's library
        data = from_rank0(lib.data if lib else None)
        if rank != 0:
            lib = BandLibrary(path, lattice, n, n_k, nev, data=data)
    logger = RunLogger(metrics_path if rank == 0 else None, echo=False)

    if indices is None:
        pending = lib.pending_indices()
        indices = pending if len(pending) < n_k else list(range(n_k))
        if not indices:
            if verbose:
                say(f"{GREEN}All indices of {diel_type},{lattice} have "
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
        salt = from_rank0(int(np.random.SeedSequence().entropy % 100003)
                          or 1)
        if verbose:
            say(f"{YELLOW}{len(failed_before)} previously-failed rows "
                f"will retry with seed salt {salt}{RESET}")

    def _seed_for(i):
        return seed + i + (salt if i in failed_before else 0)

    def _accept(result):
        """Raise unless the solve is acceptable: CONVERGED or FLOOR (or
        MAXITER with a passing validation), not spurious, and every tracked
        band's frequency-error bound res * scal^2 / (8 pi^2 omega) within
        2e-3 (pcx bandstructure.py:1656-1698)."""
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

    def _f64_report(i, result, owner):
        """The complex128 refine's report of ``result``, computed by the
        rank ``owner`` that holds its block and broadcast (here when
        ``owner`` is None)."""
        if owner is None:
            return solver._refine_report(alphas[i], result.x,
                                         raise_on_spurious=False,
                                         mode="f64")[0]
        box = [None]
        if rank == owner:
            try:
                box[0] = _f64_report(i, result, None)
            except Exception as e:  # noqa: BLE001  raised on every rank
                box[0] = e
        dist.broadcast_object_list(box, src=owner)
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]

    def _accept_or_escalate(i, result, owner=None):
        """``_accept``, with one escalation (pcx bandstructure.py:
        1700-1734): when the light refine rejects a solve on the spurious
        gate or the frequency-error bound, re-validate it with the
        complex128 refine before paying the cold retry, since the light
        refine's statistics sit at the complex64 noise floor.  Returns the
        result to commit (its report replaced after an escalation); raises
        like ``_accept`` when the complex128 refine rejects it too.
        ``owner``: the rank holding the block of a mesh group's member."""
        try:
            _accept(result)
            return result
        except RuntimeError as e:
            msg = str(e)
            if (solver.refine != "light"
                    or not ("under-converged" in msg or "spurious" in msg)):
                raise
            say(f"{YELLOW}k={i}: light-refine gate failed ({e}); "
                f"re-validating with the f64 refine{RESET}")
            report = _f64_report(i, result, owner)
            r2 = dataclasses.replace(result, report=report,
                                     omega=report.omega_pnt,
                                     omega_re=report.omega_re)
            _accept(r2)
            say(f"{GREEN}k={i}: f64 re-validation PASSED — accepting "
                f"(light-refine false rejection){RESET}")
            return r2

    # A light refine leaves a spurious verdict to _accept_or_escalate (the
    # JAX solve raises it before the escalation can see it).
    spurious_kw = ({"raise_on_spurious": False}
                   if solver.refine == "light" else {})
    last_commit_t = [time.time()]
    committed_grp = []   # members of the current group already recorded

    def _commit(i, result):
        nonlocal x_prev, prev_idx
        committed_grp.append(i)
        lib.record(i, result.iterations, result.wall_time, result.omega_re)
        logger.log_solve(RunLogger.from_result("bandgap_k", cfg,
                                               alphas[i], result))
        x_prev, prev_idx = result.x, i
        if verbose:
            now = time.time()
            say(f"Gap {i + 1}/{n_k} ({lattice}), "
                  f"alpha/pi = {np.round(alphas[i] / np.pi, 3)}: "
                  f"iters = {result.iterations}, "
                  f"t = {result.wall_time:<6.2f}s, "
                  f"wall = {now - last_commit_t[0]:.1f}s")
            last_commit_t[0] = now

    # Groups of k_batch consecutive indices through solve_batch (over the
    # mesh's k axis, if any); single indices through solve.
    groups = ([indices[j:j + k_batch]
               for j in range(0, len(indices), k_batch)]
              if k_batch > 1 else [[i] for i in indices])
    for grp in groups:
        committed_grp.clear()
        try:
            if len(grp) > 1:
                # Every member warm-starts from the last committed block
                # when the group begins next to its index (pcx
                # bandstructure.py:1758-1777).
                x0s = ([x_prev] * len(grp)
                       if (x_prev is not None and prev_idx is not None
                           and abs(grp[0] - prev_idx) <= 1) else None)
                results = solver.solve_batch([alphas[i] for i in grp],
                                             x0s=x0s, seed=_seed_for(grp[0]),
                                             mesh=mesh, **spurious_kw)
                for j, (i, result) in enumerate(zip(grp, results)):
                    owner = (None if mesh is None
                             else _member_rank(mesh, len(grp), j))
                    _commit(i, _accept_or_escalate(i, result, owner))
                continue
            i = grp[0]
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
                            say(f"{YELLOW}k={i}: warm-feeder solve of "
                                f"computed neighbor k={j} "
                                f"({feeder.iterations} iters){RESET}")
                        x_prev, prev_idx = feeder.x, j
                        warm = True
                        break
            retry_cold = False
            try:
                result = solver.solve(alphas[i],
                                      x0=(x_prev if warm else None),
                                      seed=_seed_for(i), verbose=False,
                                      **spurious_kw)
                result = _accept_or_escalate(i, result)
            except Exception as e:
                # One cold retry of a failed warm solve.  It runs after this
                # handler exits: inside it the live traceback pins the
                # failed solve's device blocks (pcx bandstructure.py:
                # 1817-1845).
                if not warm or _is_device_error(e):
                    raise
                say(f"{YELLOW}Warm-started k={i} failed ({e}); "
                    f"retrying with a cold start{RESET}")
                retry_cold = True
            if retry_cold:
                x_prev = None   # free the warm block before re-solving
                result = solver.solve(alphas[i], x0=None,
                                      seed=_seed_for(i) + 10007,
                                      verbose=False, **spurious_kw)
                result = _accept_or_escalate(i, result)
            _commit(i, result)
        except Exception as e:   # NaN, blow-up, spurious, RR failure
            # Numerical failures are recorded as [-1,-1] and the sweep goes
            # on; a device fault aborts it, since every later solve would
            # fail too and mass-fail the library (resume retries).
            if _is_device_error(e):
                say(f"{RED}DEVICE ERROR at k-points {grp}: {e} — aborting "
                    f"sweep (resume will retry){RESET}")
                raise
            say(f"{RED}WARNING: Error at k-points {grp}: {e}{RESET}")
            for i in grp:
                if i not in committed_grp:   # recorded ones stay
                    err_index.append(i)
                    lib.record(i, -1, -1, None)
            x_prev, prev_idx = None, None

    if err_index:
        say(f"{RED}Error occurs at indices: {err_index}{RESET}")
    elif verbose:
        say(f"{GREEN}All indices computed correctly.{RESET}")
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


def _library_path(output_dir: str, diel_type: str, lattice: str,
                  eps_opt: int) -> str:
    suffix = str(eps_opt) if eps_opt else ""
    return f"{output_dir}/{diel_type}/bandgap_{lattice}{suffix}.json"


def bandgap_wnk_check(n: int, lattice: str, diel_type: str = TYPE_CHIRAL,
                      eps_opt: int = 0, output_dir: str = "output",
                      indices=(), gap: Optional[int] = None):
    """Print and return (alpha, [iterations, runtime], frequencies) of
    selected k-points of a band library (reference: bandgap_wnk_check,
    numerical_experiments.py:254-276; pcx bandstructure.py:1897)."""
    lib, alphas = _open_library(
        _library_path(output_dir, diel_type, lattice, eps_opt), lattice, n,
        gap)
    out = []
    for i in indices:
        a = alphas[i] / np.pi
        it = lib.iterations[i]
        freq = np.asarray(lib.frequencies[i])
        print(f"Index = {i}, wnk = ({a[0]:<6.3f}, {a[1]:<6.3f}, "
              f"{a[2]:<6.3f})pi.")
        print(f"Iterations = {int(it[0]):4d}, runtime = {it[1]:6.3f}s.")
        print("List of frequencies follows as:")
        print(freq)
        out.append((alphas[i], it, freq))
    return out


def bandgap_history_check(n: int, lattice: str, diel_type: str = TYPE_CHIRAL,
                          eps_opt: int = 0, output_dir: str = "output",
                          gap: Optional[int] = None):
    """Report the failed and the uncomputed k-points of a band library;
    returns (failed, empty), or None when the library does not exist
    (reference: numerical_experiments.py:277-311; pcx
    bandstructure.py:1920)."""
    path = _library_path(output_dir, diel_type, lattice, eps_opt)
    if not os.path.exists(path):
        print(f"The bandgap of type {diel_type},{lattice} has no previous "
              f"record.")
        return None
    lib, _ = _open_library(path, lattice, n, gap)
    failed = lib.failed_indices()
    empty = sorted(set(lib.pending_indices()) - set(failed))
    if failed:
        print(f"{RED}Warning: Blow up results detected: {failed}.{RESET}")
    if empty:
        print(f"{YELLOW}Following indices remain uncomputed: {empty}.{RESET}")
    if not failed and not empty:
        print(f"{GREEN}All indices of {diel_type},{lattice} have been "
              f"computed without errors.{RESET}")
    return failed, empty
