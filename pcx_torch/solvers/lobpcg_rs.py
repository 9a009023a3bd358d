"""The production soft-locking LOBPCG of pcx, as a Python loop on complex
tensors, and the generalized-problem family of ``pcx/solvers/lobpcg_rs.py``
(``lobpcg_gep_rs``, ``lobpcg_sep_max_rs``, ``descent_gep_rs``).

Port of ``pcx/solvers/lobpcg_rs.py`` (``rs_solver_parts`` composed as
``lobpcg_sep_rs``, lines 43-605): fixed-shape masked soft locking, the
``w_cap`` compaction of the W and P blocks, SVQB-with-dropping
orthonormalization, the complex128-accumulated
Rayleigh-Ritz Gram (of the six blocks [X|W|P], [HX|HW|HP]: kernel K6 on the
card, or kernel K3 with ``rr_gram="pallas"``),
HX/HP refresh, the FLOOR heuristics
(``floor_patience``, ``col_patience``, ``lam_tol``/``lam_patience``/
``lam_res_tol``) and the NaN, stagnation and blow-up guards.  The reference
algorithm is lobpcg_sep_softlock, paper_2/lobpcg.py:325-492.

The big blocks stay on the device.  Once per iteration the (m,) residual
norms and Ritz values come back to the host in ONE transfer, and the
status bookkeeping of the JAX while-loop runs there on numpy scalars in the
iterate's real dtype; the active-column mask goes back as an (m,) tensor.
The loop issues no other synchronization of its own (``torch.linalg.eigh``
on CUDA checks its error flag on the host, which synchronizes).  Its spans
(``pcx_torch.tracing``) are ``pcx.precond``, ``pcx.step`` (the host's
bookkeeping from the read-back to the uploads of the masks), ``pcx.svqb``
and ``pcx.rr``; its syncs count as ``sync.readback`` and ``sync.upload``.
From what the host already holds it counts each lane's stop by its status
(``stop.converged``, ``stop.floor``, ``stop.maxiter``, ``stop.blowup``,
``stop.nan``) and, each iteration, the lanes' active (unlocked) columns
(``lobpcg.active_cols``).

``lobpcg_sep_rs_lanes`` is the lockstep k-point batch, JAX's vmapped
``_jitted_batch_rs``: L problems as lanes of one loop, one read-back and
one batched ``eigh`` per small problem for all lanes; ``lobpcg_sep_rs`` is
its one-lane case.  JAX's batched programs run without K1 and K2
(``fusions=False``, pcx/bandstructure.py:569-576, 1142-1145), because
its per-solve Pallas programs could not run under ``vmap`` on the TPU; on
the card the kernels are the path, so the lanes run K1, K2 and, with
``rr_gram="pallas"``, K3 over every running lane in one launch, wherever
the serial solve runs them.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from pcx_torch import tracing
from pcx_torch.config import MAXITER, TOL
from pcx_torch.kernels.gram9 import gram9
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.solvers.lobpcg import (STOP_COUNTERS, SolveResult, Status,
                                      _NP_REAL, _per_lane, lobpcg_gep)
from pcx_torch.utils import real_dtype


class _Tracker:
    """Host-side twin of the JAX loop state's scalar bookkeeping: residual
    history, best residuals, per-column floor locks and the Ritz-stillness
    counter, all in the iterate's real dtype (body_fun, lobpcg_rs.py:246-355).
    """

    def __init__(self, m, nev, tol, maxiter, locking, floor_patience,
                 col_patience, lam_tol, lam_patience, lam_res_tol,
                 noise_floor, f, maxstagniter=50):
        self.f = f
        self.maxstagniter = maxstagniter
        self.locking = locking
        self.nev, self.tol = nev, f(tol)
        self.floor_patience, self.col_patience = floor_patience, col_patience
        self.lam_tol, self.lam_patience = lam_tol, lam_patience
        self.res_cap_fac = f(lam_res_tol * 4.0 * np.pi)
        self.gate_fac = f(10.0 * noise_floor / 30.0)
        self.res_his = np.full((maxiter,), np.nan, f)
        self.best_res, self.best_it = f(np.inf), 0
        self.best_res_c = np.full((m,), np.inf, f)
        self.best_it_c = np.zeros((m,), np.int64)
        self.lam_still = 0
        self.prev_lam = None

    def update(self, it: int, res: np.ndarray, lam: np.ndarray):
        """(status, active mask) of iteration ``it`` from its residual norms
        and the current Ritz values."""
        f, nev = self.f, self.nev
        one = f(1.0)
        if self.lam_tol > 0.0 and self.prev_lam is not None:
            # Ritz movement of the previous step (JAX: step() of it - 1);
            # NaN movement compares False and resets the counter.
            move = np.max(np.abs(lam[:nev] - self.prev_lam[:nev])
                          / np.maximum(np.abs(lam[:nev]), one))
            self.lam_still = self.lam_still + 1 if move < self.lam_tol else 0
        self.prev_lam = lam
        res_max = np.max(res[:nev])
        res_nev = np.sqrt(np.sum(res[:nev] * res[:nev], dtype=f))
        self.res_his[it] = res_nev
        last = len(self.res_his) - 1      # JAX clamps out-of-range reads
        first_rec = self.res_his[min(1, last)]
        if res_max < self.best_res * f(0.95):
            self.best_res, self.best_it = res_max, it
        since_best = it - self.best_it
        floor_gate = self.gate_fac * np.maximum(np.max(np.abs(lam)), one)
        fp = self.floor_patience
        floored = bool(fp > 0 and since_best > fp and it > 3
                       and res_max < floor_gate)
        res_cap = self.res_cap_fac * np.sqrt(np.maximum(np.abs(lam[:nev]),
                                                        one))
        res_cap_ok = bool(np.all(res[:nev] < res_cap))
        floored |= fp > 0 and it > 3 and res_cap_ok and since_best > 4 * fp + 4
        if self.lam_tol > 0.0:
            floored |= (it > 3 and res_cap_ok
                        and self.lam_still >= self.lam_patience)

        improved_c = res < self.best_res_c * f(0.95)
        regressed_c = res > f(3.0) * self.best_res_c
        upd = improved_c | regressed_c
        self.best_res_c = np.where(upd, res, self.best_res_c)
        self.best_it_c = np.where(upd, it, self.best_it_c)
        cp = self.col_patience
        if cp > 0:
            col_gate = self.gate_fac * np.maximum(np.abs(lam), one)
            idle = it - self.best_it_c
            col_floored = (((idle > cp) & (it > 3) & (res < col_gate))
                           | ((it > 3) & (idle > 4 * cp + 4)))
        else:
            col_floored = np.zeros(res.shape, bool)
        active = ((res > self.tol) & ~col_floored if self.locking
                  else np.ones(res.shape, bool))

        ms = self.maxstagniter
        stagn_ref = np.maximum(first_rec, f(10.0) * floor_gate)
        stagn = ((it > ms and (res[0] > 1000.0 or res[0] > stagn_ref))
                 or (it > 2 * ms and res[0] > 50.0))
        recovering = res_nev < self.res_his[min(ms // 2, last)] * f(0.1)
        if np.isnan(res).any():
            status = Status.NAN
        elif res_max < self.tol:
            status = Status.CONVERGED
        elif stagn and not recovering:
            status = Status.BLOWUP
        elif floored:
            status = Status.FLOOR
        else:
            status = Status.RUNNING
        return status, active


def w_buckets(m: int) -> list:
    """The widths of ``w_cap="auto"``: {m/4, m/2, m}, at least 1 each
    (pcx/bandstructure.py:1454)."""
    return sorted({max(1, m // 4), max(1, m // 2), m})


def width_rule(w_cap, m: int, rr_gram: str = "xla"
               ) -> Callable[[int, int], int]:
    """``(it, n_act) -> width`` of the W and P blocks for ``w_cap``: None
    (m), an int (clamped to [1, m], as lobpcg_rs.py:158), ``"auto"`` (the
    smallest of ``w_buckets(m)`` that holds the ``n_act`` active columns)
    or a callable of (it, n_act), whose width is clamped the same way.
    Raises for any other value, and for a width below m with
    ``rr_gram="pallas"`` (K3 takes equal-width blocks, lobpcg_rs.py:159)."""
    def clamp(w):
        return max(1, min(int(w), m))

    if w_cap is None:
        return lambda it, n_act: m
    if isinstance(w_cap, str) and w_cap == "auto":
        buckets = w_buckets(m)
        rule = lambda it, n_act: next(b for b in buckets if n_act <= b)
    elif callable(w_cap):
        rule = lambda it, n_act: clamp(w_cap(it, n_act))
    elif isinstance(w_cap, (int, np.integer)) and not isinstance(w_cap, bool):
        wc = clamp(w_cap)
        rule = lambda it, n_act: wc
        if wc == m:
            return rule
    else:
        raise ValueError(f"w_cap must be an int, 'auto' or a callable, "
                         f"got {w_cap!r}")
    if rr_gram == "pallas":
        raise ValueError("w_cap < m is not supported with rr_gram='pallas' "
                         "(the fused Gram kernel K3 assumes equal-width "
                         "basis blocks)")
    return rule


def lobpcg_sep_rs(
    h_func: Callable[[torch.Tensor], torch.Tensor],
    p_func: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    nev: int,
    *,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 2,
    refresh_every: int = 5,
    floor_patience: int = 9,
    use_p: bool = True,
    rp_fused=None,
    w_cap=None,
    col_patience: int = 0,
    lam_tol: float = 0.0,
    lam_patience: int = 3,
    lam_res_tol: float = 1e-3,
    rr_gram: str = "xla",
    limit: Optional[int] = None,
    monitor: Optional[Callable[[int, np.ndarray, torch.Tensor], bool]] = None,
    widths: Optional[list] = None,
) -> SolveResult:
    """Soft-locking LOBPCG for the lowest ``nev`` eigenpairs of H.

    ``h_func``/``p_func`` map a block shaped like ``x0`` (m, ...) to H x and
    to the preconditioned block.  The options mean what they mean in
    ``pcx.solvers.lobpcg_rs.rs_solver_parts`` (see its docstring).

    ``locking=False`` (the ``nolock`` variant) gives every column a W and P
    direction in every iteration, whatever its residual or per-column floor
    lock; ``use_p=False`` (the ``descent`` variant, reference descent_sep,
    paper_2/lobpcg.py:847-974) keeps the conjugate block P out of the basis.

    ``rp_fused``: optional ``(x, hx, lam) -> (w_raw, sumsq)`` on flat (m, D)
    blocks, replacing the residual / column-norm / preconditioner chain by
    one fused pass (kernel K1); ``p_func`` is then not called in the loop.

    ``rr_gram`` keeps the JAX option's name and values: ``"xla"`` forms the
    Rayleigh-Ritz Gram [X|W|P]^H [HX|HW|HP] as one ``gram_f64`` of the six
    blocks (kernel K6 on the card, which reads them where they lie) and
    updates X over the X, W and P rows in one combination; ``"pallas"``
    names the fused-Gram kernel K3 (``pcx_torch.kernels.gram9``), whatever
    the device (the kernel on CUDA tensors, its plain version on CPU ones),
    with the operands rounded to complex64 as the TPU kernel does, and adds
    P' to X C_x last (pcx/solvers/lobpcg_rs.py:496-510).  Every block
    combination is ``rr.combine`` (kernel K4 on the card) on the blocks
    where they lie: neither route concatenates them.

    ``w_cap`` caps the width of the W and P blocks (lobpcg_rs.py:88-102,
    364-470): each iteration the ``wc`` columns of highest residual among
    the active ones (unconverged and not floor-locked; a stable argsort of
    -(active * res), ties by index) are gathered to the front of (wc, D)
    blocks, so that the preconditioner, the operator apply on W, both
    SVQBs and the Rayleigh-Ritz run at width m + 2 wc instead of 3m; P and
    H P stay m wide, and their gathered rows take part.  With more than wc
    active columns the rest get no direction this iteration, but stay in X
    and monitored.  At wc == m nothing is gathered and the computation is
    that of ``w_cap=None``.  ``w_cap`` is an int, ``"auto"`` or a callable
    ``(it, n_act) -> width`` (``width_rule``).  ``"auto"`` takes, each
    iteration, the smallest of the JAX buckets {m/4, m/2, m} that holds
    this iteration's active count: JAX's rule at ``segment_iters=1``,
    except that its trampoline reads the count of the previous iteration
    (its widths are separate programs, entered at segment boundaries).
    ``widths``: a list that receives the width of every iteration.

    ``maxstagniter``: the stagnation window of the blow-up guard.

    ``limit``: stop after this many iterations (status MAXITER) — the warm
    start cap of KPointSolver.  ``monitor(it, res, lambdas)``: called after
    each step with the iteration count, the host residuals and the device
    Ritz values; returning True stops the solve (status MAXITER).

    The body is ``lobpcg_sep_rs_lanes`` with one lane.
    """
    def one(f):
        return lambda a, lanes: f(a[0])[None]

    rp = (None if rp_fused is None else
          lambda x, hx, lam, lanes: tuple(
              a[None] for a in rp_fused(x[0], hx[0], lam[0])))
    res, = lobpcg_sep_rs_lanes(
        one(h_func), one(p_func), x0[None], nev, tol=tol, maxiter=maxiter,
        locking=locking, maxstagniter=maxstagniter,
        ortho_passes=ortho_passes, refresh_every=[refresh_every],
        floor_patience=floor_patience, use_p=use_p, rp_fused=rp,
        w_cap=w_cap, col_patience=col_patience, lam_tol=lam_tol,
        lam_patience=lam_patience, lam_res_tol=lam_res_tol, rr_gram=rr_gram,
        limit=[limit], monitor=[monitor],
        widths=[[] if widths is None else widths])
    return res


def lobpcg_sep_rs_lanes(
    h_func: Callable[[torch.Tensor, tuple], torch.Tensor],
    p_func: Callable[[torch.Tensor, tuple], torch.Tensor],
    x0: torch.Tensor,
    nev: int,
    *,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 2,
    refresh_every=5,
    floor_patience: int = 9,
    use_p: bool = True,
    rp_fused=None,
    w_cap=None,
    col_patience: int = 0,
    lam_tol: float = 0.0,
    lam_patience: int = 3,
    lam_res_tol: float = 1e-3,
    rr_gram: str = "xla",
    limit=None,
    monitor=None,
    widths: Optional[list] = None,
) -> list:
    """``lobpcg_sep_rs`` on L independent problems in lockstep: the
    production LOBPCG with a leading lane axis, as JAX's k-point batch runs
    it (``jax.vmap`` of ``lobpcg_sep_rs`` in pcx/bandstructure.py:1132-1159,
    ``_jitted_batch_rs``).  Returns one ``SolveResult`` per lane, each the
    result that lane's serial solve computes.

    ``x0`` is (L, m, ...).  ``h_func(a, lanes)`` and ``p_func(a, lanes)``
    map a block (R, c, ...) of the R running lanes ``lanes`` (a tuple of
    lane indices, in order) to H and the preconditioner of each lane;
    ``rp_fused(x, hx, lam, lanes)`` is the fused hook on flat (R, m, D)
    blocks and (R, m) Ritz values (kernel K1 on the lane axis).
    ``rr_gram="pallas"`` runs kernel K3 on the lane axis.

    Every small Hermitian problem of an iteration is one batched
    ``torch.linalg.eigh`` over the lanes, and the iteration reads the
    lanes' residuals and Ritz values back in one (R, 2m) transfer.  Each
    lane keeps its own host bookkeeping (``_Tracker``), so its status,
    floor locks and active columns are its own.  A lane that stops, by its
    status, its ``limit`` or its ``monitor``, leaves the working batch: the
    running lanes are selected on the lane axis and the stopped lane's
    result is stored.  (JAX's batched while-loop computes finished lanes on
    under a select; that is how XLA batches a loop, and is not ported.)

    Per lane (a value, or a sequence of L values): ``refresh_every`` (a
    lane refreshes H X and H P at its own period), ``limit`` and
    ``monitor``.  ``widths``: a list of L lists, each receiving its lane's
    width per iteration.

    ``w_cap``: all lanes of an iteration take one width, the largest of the
    lanes' widths under the rule.  An int cap is the same for every lane
    and gathers each lane's own columns; ``"auto"`` runs every lane at the
    largest bucket of the running lanes, which holds each lane's active
    columns, so a lane's extra slots are masked (the buckets drop only
    masked columns: the same Ritz pairs).  The other options are those of
    ``lobpcg_sep_rs``, shared by the lanes.
    """
    if rr_gram not in ("xla", "pallas"):
        raise ValueError(f"unknown rr_gram {rr_gram!r}")
    if lam_tol > 0.0 and lam_patience < 1:
        raise ValueError("lam_patience must be >= 1 (the stillness counter "
                         "starts at 0, so 0 would stop unconditionally)")
    n_lanes = x0.shape[0]
    shape = x0.shape[1:]
    m = shape[0]
    cdtype = x0.dtype
    rdtype = real_dtype(cdtype)
    dev = x0.device
    finfo = torch.finfo(rdtype)
    tiny = float(finfo.tiny ** 0.5)
    dim = int(np.prod(shape[1:]))
    noise_floor = 30.0 * (dim ** 0.5) * float(finfo.eps)
    rr_split = rr.split_for(rdtype)
    width = width_rule(w_cap, m, rr_gram)
    refresh = _per_lane(refresh_every, n_lanes)
    stops = [maxiter if lim is None else min(lim, maxiter)
             for lim in _per_lane(limit, n_lanes)]
    monitors = _per_lane(monitor, n_lanes)
    widths = [[] for _ in range(n_lanes)] if widths is None else widths

    def hf(a: torch.Tensor, lanes: tuple) -> torch.Tensor:
        r, c = a.shape[:2]
        return h_func(a.reshape((r, c) + shape[1:]), lanes).reshape(r, c, -1)

    def unit_scale(a: torch.Tensor) -> torch.Tensor:
        """The scale of a's rows to unit norm, (L, c)."""
        return 1.0 / rr.colnorms(a, lanes=True).clamp(min=tiny)

    def unit_cols(a: torch.Tensor) -> torch.Tensor:
        return rr.scale_cols(a, unit_scale(a))

    def masked_rr(t: torch.Tensor, mask: torch.Tensor, sentinel: float):
        """Hermitize each lane's T on its kept rows/columns and decouple the
        dead ones at sentinel * (||T||_F + 1) on the diagonal."""
        mask64 = mask.to(torch.float64)
        t = rr.hermitize(t) * (mask64[..., :, None] * mask64[..., None, :])
        dead = torch.linalg.vector_norm(t, dim=(-2, -1)) + 1.0
        t = t + sentinel * dead[..., None, None] * torch.diag_embed(
            1.0 - mask64)
        return rr.eigh_split(t, rr_split)

    # ---- initialization: orthonormalize + Ritz-rotate the start ----------
    run = tuple(range(n_lanes))
    ones_m = torch.ones((n_lanes, m), dtype=rdtype, device=dev)
    xf, _, keep0 = rr.masked_svqb_drop(
        unit_cols(x0.reshape(n_lanes, m, -1)), ones_m, noise_floor, passes=1)
    hxf = hf(xf, run)
    # Rank-deficient starts: the dropped (zero) columns sort ABOVE the
    # spectrum, never as phantom theta=0 below it.
    theta0, v0 = masked_rr(rr.gram_f64(xf, hxf), keep0, +1.0)
    c0 = v0.to(cdtype) * keep0[..., :, None]
    x, hx = rr.mix(c0, xf), rr.mix(c0, hxf)
    del xf, hxf
    lambdas = theta0.to(rdtype)
    p, hp = torch.zeros_like(x), torch.zeros_like(x)
    arange_m = torch.arange(m, device=dev)
    # valid-column mask of X in sorted position (zero columns trail)
    x_ok = (arange_m < keep0.sum(-1, keepdim=True)).to(rdtype)

    f = _NP_REAL[rdtype]
    trks = [_Tracker(m, nev, tol, maxiter, locking, floor_patience,
                     col_patience, lam_tol, lam_patience, lam_res_tol,
                     noise_floor, f, maxstagniter) for _ in run]
    done = [None] * n_lanes
    it = 0

    def retire(stopped: dict, extra=()):
        """Store the lanes at rows ``stopped`` ({row: status}) and select
        the others on the lane axis of the state and of ``extra``."""
        nonlocal run, x, hx, p, hp, lambdas, x_ok
        if not stopped:
            return extra
        last = len(stopped) == len(run)
        for row, st in stopped.items():
            # a lane that stops while others run keeps a copy of its block:
            # a view would pin the whole batch's
            xl = x[row] if last else x[row].clone()
            done[run[row]] = (lambdas[row], xl, it, st)
        keep = [j for j in range(len(run)) if j not in stopped]
        run = tuple(run[j] for j in keep)
        if not run:
            return extra
        tracing.count("sync.upload")
        idx = torch.as_tensor(keep, device=dev)
        x, hx, p, hp, lambdas, x_ok = (a.index_select(0, idx) for a in
                                       (x, hx, p, hp, lambdas, x_ok))
        return tuple(None if a is None else a.index_select(0, idx)
                     for a in extra)

    while run:
        retire({j: Status.RUNNING for j, lane in enumerate(run)
                if it >= stops[lane]})
        if not run:
            break
        due = [j for j, lane in enumerate(run) if refresh[lane] > 0
               and it > 0 and it % refresh[lane] == 0]
        if len(due) == len(run):
            hx, hp = hf(x, run), hf(p, run)
        elif due:
            tracing.count("sync.upload")
            idx = torch.as_tensor(due, device=dev)
            sub = tuple(run[j] for j in due)
            hx.index_copy_(0, idx, hf(x.index_select(0, idx), sub))
            hp.index_copy_(0, idx, hf(p.index_select(0, idx), sub))
        r = w_raw = None
        if rp_fused is None:
            r = lambdas[..., None] * x - hx
            res = rr.colnorms(r, lanes=True)
        else:
            with tracing.span("pcx.precond"):
                w_raw, sumsq = rp_fused(x, hx, lambdas, run)
            res = torch.sqrt(sumsq).to(rdtype)
        with tracing.span("pcx.step"):
            tracing.count("sync.readback")   # the one sync
            host = torch.cat((res, lambdas), dim=-1).cpu().numpy()
            res_h, lam_h = host[:, :m], host[:, m:]
            stopped, actives = {}, []
            for j, lane in enumerate(run):
                if it > 0 and np.isnan(lam_h[j]).any():
                    # the previous Rayleigh-Ritz failed
                    stopped[j] = Status.NAN
                    continue
                st, act = trks[lane].update(it, res_h[j], lam_h[j])
                if st != Status.RUNNING:
                    stopped[j] = st
                else:
                    actives.append(act)
            if stopped:
                res_h = np.delete(res_h, list(stopped), axis=0)
                r, w_raw = retire(stopped, (r, w_raw))
            if not run:
                break
            n_run = len(run)
            active_h = np.stack(actives)
            tracing.count("lobpcg.active_cols", int(active_h.sum()))

            # ---- step: W = P R on the active columns, P, Rayleigh-Ritz ----
            wc = max(width(it, int(a.sum())) for a in active_h)
            for lane in run:
                widths[lane].append(wc)
            if wc < m:
                # each lane's wc active columns of highest residual, on the
                # host (lobpcg_rs.py:368-381): residual priority, so that a
                # fixed cap below the active count rotates its slots
                idx_h = np.argsort(-(active_h.astype(f) * res_h), axis=1,
                                   kind="stable")[:, :wc]
                tracing.count("sync.upload", 2)
                gidx = torch.as_tensor(idx_h, device=dev)[..., None]
                sel = torch.as_tensor(np.take_along_axis(active_h, idx_h, 1),
                                      device=dev).to(rdtype)

                def gather(a: torch.Tensor) -> torch.Tensor:
                    return torch.gather(a, 1, gidx.expand(-1, -1, a.shape[-1]))
            else:
                tracing.count("sync.upload")
                sel = torch.as_tensor(active_h, device=dev).to(rdtype)

                def gather(a: torch.Tensor) -> torch.Tensor:
                    return a
            acol = sel[..., None]
        if rp_fused is None:
            with tracing.span("pcx.precond"):
                w = p_func((acol * gather(r)).reshape((n_run, wc) + shape[1:]),
                           run)
                w = w.reshape(n_run, wc, -1)
        else:
            w = gather(w_raw)
        del r, w_raw
        # W and P enter their SVQB as unit columns on the active mask,
        # s * block with s = mask / norm: the first projection (K6's Gram,
        # K4's addends) scales the rows as it reads them, and no scaled
        # copy is written.  An active row's norm is its masked row's and a
        # masked row's s is 0, so this is the masked unit block, bit for
        # bit.
        w, _, w_ok = rr.masked_svqb_drop(
            w, sel, noise_floor, against=(x,), passes=ortho_passes,
            scale=sel * unit_scale(w))
        hw = hf(w, run)

        p_act = sel * (1.0 if it > 0 and use_p else 0.0)
        pg = gather(p)
        ps = p_act * unit_scale(pg)
        pf, hpf, p_ok = rr.masked_svqb_drop(
            pg, p_act, noise_floor, hblock=gather(hp), against=(x, w),
            h_against=(hx, hw), passes=ortho_passes, scale=ps)
        del pg

        with tracing.span("pcx.rr"):
            basis_mask = torch.cat((x_ok, w_ok, p_ok), dim=-1)
            if rr_gram == "pallas":
                t = gram9(*(a.to(torch.complex64)
                           for a in (x, w, pf, hx, hw, hpf)))
            else:
                t = rr.gram_f64((x, w, pf), (hx, hw, hpf))
            theta_all, v = masked_rr(t, basis_mask, -1.0)
            c_all = v.to(cdtype) * basis_mask[..., :, None]
            # The dead columns sort first: the window of m Ritz pairs starts
            # after them (clamped like lax.dynamic_slice).
            nb = m + 2 * wc
            valid = basis_mask.sum(-1, keepdim=True)
            start = (nb - valid).clamp(0, nb - m).long()
            idx = start + arange_m
            x_ok = (arange_m >= (m - valid).clamp(min=0)).to(rdtype)
            c = torch.gather(c_all, -1, idx[:, None, :].expand(-1, nb, -1))
            lambdas = torch.gather(theta_all.to(rdtype), -1, idx)
            # Each route keeps its order of summation: "xla" sums X' over
            # the X, W, P rows in one combination (P' + X C_x rounds
            # otherwise and took warm complex64 points at N=120 3-4% more
            # iterations to FLOOR), "pallas" adds P' to X C_x last.
            cx, cw, cp = c[:, :m], c[:, m:m + wc], c[:, m + wc:]
            p = rr.combine((w, pf), (cw, cp))
            hp = rr.combine((hw, hpf), (cw, cp))
            if rr_gram == "pallas":
                x = rr.combine((x,), (cx,), p)
                hx = rr.combine((hx,), (cx,), hp)
            else:
                x = rr.combine((x, w, pf), (cx, cw, cp))
                hx = rr.combine((hx, hw, hpf), (cx, cw, cp))
            del w, hw, pf, hpf
        it += 1
        retire({j: Status.RUNNING for j, lane in enumerate(run)
                if monitors[lane] is not None and it < stops[lane]
                and monitors[lane](it, res_h[j], lambdas[j])})

    out = []
    for lane, (lam, xl, its, status) in enumerate(done):
        if status == Status.RUNNING:
            # stopped by the limit or the monitor: a NaN from the last
            # Rayleigh-Ritz still reports NAN, as the JAX step does
            tracing.count("sync.result")
            status = (Status.NAN if bool(torch.isnan(lam).any())
                      else Status.MAXITER)
        tracing.count(STOP_COUNTERS[status])
        out.append(SolveResult(lambdas=lam, x=xl.reshape(shape),
                               iterations=its, status=int(status),
                               res_history=trks[lane].res_his))
    return out


def lobpcg_gep_rs(h_func, m_func, p_func, x0: torch.Tensor, nev: int, *,
                  tol: float = TOL, maxiter: int = MAXITER,
                  locking: bool = True, normalize: bool = True,
                  use_p: bool = True, floor_patience: int = 10
                  ) -> SolveResult:
    """LOBPCG for H x = lambda M x (M Hermitian positive definite), the
    algorithm of ``pcx.solvers.lobpcg_rs.lobpcg_gep_rs``.

    The JAX function is the (re, im) pair transform of the complex
    ``lobpcg_gep`` that the TPU needed; here it is ``lobpcg_gep`` on
    complex tensors with the twin's rules: complex128-accumulated Grams,
    the whitened pencil with the degeneracy split of the iterate dtype,
    a FLOOR stop after ``floor_patience`` iterations without a 5%
    improvement (0 disables), and on any stop but CONVERGED the Ritz values
    of the best iteration: past the complex64 floor the noisy Grams breed
    below-spectrum phantoms in the current ones.
    """
    pencil = functools.partial(rr.pencil_eigh,
                               split=rr.split_for(real_dtype(x0.dtype)))
    return lobpcg_gep(h_func, m_func, p_func, x0, nev, tol=tol,
                      maxiter=maxiter, locking=locking, normalize=normalize,
                      use_p=use_p, rr_pencil=pencil,
                      floor_patience=floor_patience, f64_gram=True,
                      best_on_stop=True)


def lobpcg_sep_max_rs(h_func, x0: torch.Tensor, nev: int, *,
                      tol: float = TOL, maxiter: int = MAXITER
                      ) -> SolveResult:
    """Largest eigenvalues of H through the inverse pencil I x = mu H x by
    ``lobpcg_gep_rs`` without locking (twin of lobpcg_sep_max; reference
    paper_2/lobpcg.py:196-323)."""
    r = lobpcg_gep_rs(lambda v: v, h_func, lambda v: v, x0, nev, tol=tol,
                      maxiter=maxiter, locking=False)
    return r._replace(lambdas=1.0 / r.lambdas)


def descent_gep_rs(h_func, m_func, p_func, x0: torch.Tensor, nev: int,
                   **kw) -> SolveResult:
    """Two-term steepest descent for the generalized problem (twin of
    descent_gep; reference paper_2/lobpcg.py:976-1100)."""
    kw["use_p"] = False
    return lobpcg_gep_rs(h_func, m_func, p_func, x0, nev, **kw)
