"""Blocked LOBPCG (Knyazev) with fixed-shape soft locking: the complex
solver family of ``pcx/solvers/lobpcg.py``, and the status codes and result
type (values of ``pcx/solvers/lobpcg.py:35-52``).

``lobpcg_sep`` (reference lobpcg_sep_softlock, paper_2/lobpcg.py:325-492)
with its nolock, descent and mixed-precision forms, and their lockstep
k-point batch ``lobpcg_sep_lanes`` (JAX's vmapped ``_jitted_batch``), of
which ``lobpcg_sep`` is the one-lane case; the generalized
``lobpcg_gep`` (lobpcg_gep_softlock, :688-838) with the largest-eigenvalue
form ``lobpcg_sep_max`` and ``descent_gep``; the dense-matrix entry
``lobpcg_default`` (:28-61) and ``lobpcg_svd``.

As in ``lobpcg_rs``, the loops are Python loops on complex tensors: the big
blocks stay on the device, and once per iteration the residual norms and
Ritz values come back to the host in one transfer, where the status rules
of the JAX while-loop run on numpy scalars in the iterate's real dtype.
The small dense problems run in complex128 with ``torch.linalg`` (no real
embedding).  ``lobpcg_sep_lanes`` counts what ``lobpcg_rs`` counts from the
host's bookkeeping: each lane's stop by its status (``STOP_COUNTERS``) and
the active columns of every iteration (``lobpcg.active_cols``).
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pcx_torch import tracing
from pcx_torch.config import MAXITER, TOL
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.utils import real_dtype


class Status(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    MAXITER = 2
    NAN = 3
    BLOWUP = 4
    # Residuals stopped improving at the single-precision noise floor of the
    # operator apply: the best attainable point.  The caller's
    # spurious-eigenvalue validation decides acceptability.
    FLOOR = 5


class SolveResult(NamedTuple):
    lambdas: torch.Tensor       # (m,) Ritz values (shift removed)
    x: torch.Tensor             # (m, ...) Ritz vectors
    iterations: int
    status: int                 # Status
    res_history: np.ndarray     # (maxiter,) norm of res[:nev], nan-padded


_NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}

# The counter of a lane's stop, by its final status (``pcx_torch.tracing``).
STOP_COUNTERS = {s: f"stop.{s.name.lower()}" for s in Status
                 if s != Status.RUNNING}


def col_normalize(block: torch.Tensor, eps: float, reduce_axis=None,
                  lanes: bool = False):
    """Unit columns (rows of the block) and their norms; norms below
    ``eps`` divide by ``eps``.  With ``lanes``, of each lane of an
    (L, m, ...) block."""
    n = rr.colnorms(block, reduce_axis, lanes=lanes)
    return rr.scale_cols(block, 1.0 / n.clamp(min=eps)), n


def one_lane(fn: Callable[[torch.Tensor], torch.Tensor]):
    """A block function ``fn(v)`` as the lane function of one lane
    (``lobpcg_sep_lanes``'s ``h_func(a, lanes)``)."""
    return lambda a, lanes: fn(a[0])[None]


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)


def _window(theta_all: torch.Tensor, c_all: torch.Tensor,
            basis_mask: torch.Tensor, m: int):
    """The m Ritz pairs after the dead coordinates, which sort first (the
    JAX ``lax.dynamic_slice`` at 3m - sum(mask), clamped like it), with the
    dead rows of C zeroed.  Lanes: (L, nb) values, (L, nb, nb) vectors and
    (L, nb) masks, each lane with its own window."""
    nb = basis_mask.shape[-1]
    start = (nb - basis_mask.sum(-1, keepdim=True)).round().clamp(
        0, nb - m).long()
    idx = start + torch.arange(m, device=theta_all.device)
    c = torch.gather(c_all, -1, idx[..., None, :].expand(
        c_all.shape[:-1] + (m,)))
    c = c * basis_mask.to(c_all.dtype)[..., :, None]
    return torch.gather(theta_all, -1, idx), c


def _block_update(c: torch.Tensor, m: int, blocks):
    """X C_x + P_new and P_new = W C_w + P C_p of one set of blocks (X, W,
    P) (reference _sep_update_after_rr, lobpcg.py:1248-1270), each one
    ``rr.combine`` over the blocks where they lie; blocks and C may carry a
    leading lane axis."""
    x, w, p = blocks
    pn = rr.combine((w, p), (c[..., m:2 * m, :], c[..., 2 * m:, :]))
    return rr.combine((x,), (c[..., :m, :],), pn), pn


class _SepTracker:
    """Host-side status rules of one lane of ``lobpcg_sep_lanes`` (the JAX
    while-loop's scalar bookkeeping, pcx/solvers/lobpcg.py), on numpy
    scalars in the iterate's real dtype: residual history, best residual,
    FLOOR, stagnation and blow-up."""

    def __init__(self, nev, tol, maxiter, maxstagniter, floor_patience,
                 noise_floor, f):
        self.nev, self.tol, self.f = nev, tol, f
        self.maxstagniter, self.floor_patience = maxstagniter, floor_patience
        self.gate_fac = f(10.0 * noise_floor / 30.0)
        self.res_his = np.full((maxiter,), np.nan, f)
        self.best_res, self.best_it = f(np.inf), 0

    def update(self, it: int, res: np.ndarray, lam: np.ndarray) -> Status:
        """The status after iteration ``it``'s residual norms ``res`` and
        Ritz values ``lam``."""
        f, nev, ms = self.f, self.nev, self.maxstagniter
        last = len(self.res_his) - 1      # JAX clamps out-of-range reads
        res_max = np.max(res[:nev])
        res_nev = np.sqrt(np.sum(res[:nev] * res[:nev], dtype=f))
        self.res_his[it] = res_nev
        first_rec = self.res_his[min(1, last)]
        if res_max < self.best_res * f(0.95):
            self.best_res, self.best_it = res_max, it
        floor_gate = self.gate_fac * np.maximum(np.max(np.abs(lam)), f(1.0))
        fp = self.floor_patience
        since_best = it - self.best_it
        floored = bool(fp > 0 and since_best > fp and it > 3
                       and res_max < floor_gate)
        floored |= fp > 0 and it > 3 and since_best > 4 * fp + 4
        stagn_ref = np.maximum(first_rec, f(10.0) * floor_gate)
        stagn = ((it > ms and (res[0] > 1000.0 or res[0] > stagn_ref))
                 or (it > 2 * ms and res[0] > 50.0))
        recovering = res_nev < self.res_his[min(ms // 2, last)] * f(0.1)
        if np.isnan(res).any():
            return Status.NAN
        if res_max < self.tol:
            return Status.CONVERGED
        if stagn and not recovering:
            return Status.BLOWUP
        if floored:
            return Status.FLOOR
        return Status.RUNNING


def lobpcg_sep(
    h_func: Callable[[torch.Tensor], torch.Tensor],
    p_func: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    nev: int,
    *,
    shift: float = 0.0,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    normalize: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 1,
    rr_mode: str = "auto",
    refresh_every: int = 10,
    floor_patience: int = 9,
    reduce_axis=None,
    use_p: bool = True,
    rr_mirror: bool = False,
    ortho: str = "svqb",
) -> SolveResult:
    """LOBPCG for the standard Hermitian eigenproblem H x = lambda x
    (``pcx.solvers.lobpcg.lobpcg_sep``; the options mean what they mean
    there).  ``h_func``/``p_func`` map blocks shaped like ``x0`` (m, ...).

    ``rr_mode``: ``"auto"`` takes the complex128-accumulated Rayleigh-Ritz
    (Loewdin start, ``gram_f64`` blocks, split eigh) for complex64 iterates
    and the working-precision one (Cholesky Rayleigh-Ritz start, plain
    eigh) otherwise; ``"f64"`` forces the former.  ``"fast"`` names the
    JAX option that runs the embedding eigh in float32 and refines its Ritz
    values; here it is ``"f64"``, since the complex128 eigh is native.
    ``ortho``: ``"svqb"`` (SVQB with dropping) or ``"mgs"`` (masked MGS).
    ``locking=False`` is the reference's nolock variant (paper_2/
    lobpcg.py:76-193); ``use_p=False`` the two-term descent.

    ``reduce_axis``: the process group over which the vector dimension of
    ``x0`` is sharded (the grid-sharded solve, ``pcx_torch.parallel.
    solve``).  Every norm and Gram is all-reduced over it, so the Ritz
    values, residual norms and masks that the host's status rules read are
    the same on every rank, and every rank takes the same branches.  As in
    JAX, where ``shard_map`` shows the solver its local shard, the noise
    floor of the FLOOR rule is computed from the LOCAL shard's dimension.

    The body is ``lobpcg_sep_lanes`` with one lane.
    """
    res, = lobpcg_sep_lanes(
        one_lane(h_func), one_lane(p_func), x0[None], nev, shift=shift,
        tol=tol, maxiter=maxiter, locking=locking, normalize=normalize,
        maxstagniter=maxstagniter, ortho_passes=ortho_passes,
        rr_mode=rr_mode, refresh_every=refresh_every,
        floor_patience=floor_patience, reduce_axis=reduce_axis, use_p=use_p,
        rr_mirror=rr_mirror, ortho=ortho)
    return res


def lobpcg_sep_lanes(
    h_func: Callable[[torch.Tensor, tuple], torch.Tensor],
    p_func: Callable[[torch.Tensor, tuple], torch.Tensor],
    x0: torch.Tensor,
    nev: int,
    *,
    shift: float = 0.0,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    normalize: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 1,
    rr_mode: str = "auto",
    refresh_every=10,
    floor_patience: int = 9,
    reduce_axis=None,
    use_p: bool = True,
    rr_mirror: bool = False,
    ortho: str = "svqb",
) -> list:
    """``lobpcg_sep`` on L independent problems in lockstep, as JAX's
    k-point batch of the complex family runs it (``jax.vmap`` of
    ``lobpcg_sep`` in pcx/bandstructure.py:1110-1129, ``_jitted_batch``).
    Returns one ``SolveResult`` per lane, each the result that lane's
    serial solve computes.

    ``x0`` is (L, m, ...).  ``h_func(a, lanes)`` and ``p_func(a, lanes)``
    map a block (R, c, ...) of the R running lanes ``lanes`` (a tuple of
    lane indices, in order) to H and the preconditioner of each lane.
    ``refresh_every`` is a value or a sequence of L values: a lane
    refreshes H X and H P at its own period.  The other options are those
    of ``lobpcg_sep``, shared by the lanes; ``shift`` is one scalar.

    Every small Hermitian problem of an iteration is one batched
    ``torch.linalg`` call over the lanes, the nine Gram blocks are formed
    per lane, and the iteration reads the lanes' residual norms and Ritz
    values back in one (R, 2m) transfer.  Each lane keeps its own status
    rules (``_SepTracker``) and active columns.  A lane that stops leaves
    the working batch: the running lanes are selected on the lane axis and
    the stopped lane's result is stored (JAX's batched while-loop computes
    it on under a select, which is not ported).
    """
    if ortho not in ("svqb", "mgs"):
        raise ValueError(f"unknown ortho {ortho!r}")
    n_lanes = x0.shape[0]
    shape = x0.shape[1:]
    m = shape[0]
    cdtype = x0.dtype
    rdtype = real_dtype(cdtype)
    dev = x0.device
    finfo = torch.finfo(rdtype)
    tiny = float(finfo.tiny ** 0.5)
    jitter = 100.0 * float(finfo.eps)
    dim = int(np.prod(shape[1:]))
    noise_floor = 30.0 * (dim ** 0.5) * float(finfo.eps)
    f = _NP_REAL[rdtype]
    red = reduce_axis
    refresh = _per_lane(refresh_every, n_lanes)

    if shift != 0.0:
        h_in = h_func
        h_func = lambda v, lanes: h_in(v, lanes) + shift * v   # noqa: E731

    def hf(a: torch.Tensor, lanes: tuple) -> torch.Tensor:
        r, c = a.shape[:2]
        return h_func(a.reshape((r, c) + shape[1:]), lanes).reshape(r, c, -1)

    use_f64_rr = rr_mode in ("f64", "fast") or (
        rr_mode == "auto" and cdtype == torch.complex64)
    split = rr.split_for(rdtype)
    ortho_fn = rr.masked_svqb_drop if ortho == "svqb" else rr.masked_mgs

    # ---- initialization: Ritz-rotate the start block ---------------------
    run = tuple(range(n_lanes))
    x = x0.reshape(n_lanes, m, -1)
    if normalize:
        x, _ = col_normalize(x, tiny, red, lanes=True)
    if use_f64_rr:
        ones = torch.ones((n_lanes, m), dtype=rdtype, device=dev)
        xf, _ = rr.masked_loewdin(x, ones, jitter, reduce_axis=red)
        hxf = hf(xf, run)
        theta0, v0 = rr.eigh_split(
            rr.hermitize(rr.gram_f64(xf, hxf, reduce_axis=red)), split)
        c0 = v0.to(cdtype)
    else:
        xf, hxf = x, hf(x, run)
        theta0, c0 = rr.rayleigh_ritz(xf, hxf, red)
        theta0 = theta0.real
    x, hx = rr.mix(c0, xf), rr.mix(c0, hxf)
    del xf, hxf
    lambdas = theta0.to(rdtype)
    p, hp = torch.zeros_like(x), torch.zeros_like(x)

    trks = [_SepTracker(nev, tol, maxiter, maxstagniter, floor_patience,
                        noise_floor, f) for _ in run]
    done = [None] * n_lanes
    it = 0

    def retire(stopped: dict, extra=()):
        """Store the lanes at rows ``stopped`` ({row: status}) and select
        the others on the lane axis of the state and of ``extra``."""
        nonlocal run, x, hx, p, hp, lambdas
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
        idx = torch.as_tensor(keep, device=dev)
        x, hx, p, hp, lambdas = (a.index_select(0, idx)
                                 for a in (x, hx, p, hp, lambdas))
        return tuple(a.index_select(0, idx) for a in extra)

    while run:
        if it >= maxiter:
            retire({j: Status.RUNNING for j in range(len(run))})
            break
        due = [j for j, lane in enumerate(run) if refresh[lane] > 0
               and it > 0 and it % refresh[lane] == 0]
        if len(due) == len(run):
            hx, hp = hf(x, run), hf(p, run)
        elif due:
            idx = torch.as_tensor(due, device=dev)
            sub = tuple(run[j] for j in due)
            hx.index_copy_(0, idx, hf(x.index_select(0, idx), sub))
            hp.index_copy_(0, idx, hf(p.index_select(0, idx), sub))
        r = lambdas.to(cdtype)[..., None] * x - hx
        res_t = rr.colnorms(r, red, lanes=True)
        host = torch.cat((res_t, lambdas), dim=-1).cpu().numpy()  # one sync
        res_h, lam_h = host[:, :m], host[:, m:]
        stopped, actives = {}, []
        for j, lane in enumerate(run):
            if it > 0 and np.isnan(lam_h[j]).any():
                stopped[j] = Status.NAN   # the previous Rayleigh-Ritz failed
                continue
            st = trks[lane].update(it, res_h[j], lam_h[j])
            if st != Status.RUNNING:
                stopped[j] = st
            else:
                actives.append(res_h[j] > tol)
        if stopped:
            r, = retire(stopped, (r,))
        if not run:
            break
        n_run = len(run)

        # ---- step: W = P R on the active columns, P, Rayleigh-Ritz --------
        ones = torch.ones((n_run, m), dtype=rdtype, device=dev)
        active_h = np.stack(actives)
        tracing.count("lobpcg.active_cols",
                      int(active_h.sum()) if locking else n_run * m)
        active = (torch.as_tensor(active_h, device=dev).to(rdtype)
                  if locking else ones)
        acol = active[..., None]
        w = p_func((acol * r).reshape((n_run, m) + shape[1:]), run)
        del r
        wf, _ = col_normalize(w.reshape(n_run, m, -1) * acol, tiny, red,
                              lanes=True)
        del w
        wf, _, w_ok = ortho_fn(wf, active, noise_floor, against=(x,),
                               passes=ortho_passes, reduce_axis=red)
        hwf = hf(wf, run)
        p_act = active * (1.0 if it > 0 and use_p else 0.0)
        pcol = p_act[..., None]
        pf, pn = col_normalize(pcol * p, tiny, red, lanes=True)
        hpf = (pcol * hp) * (1.0 / pn.clamp(min=tiny))[..., None]
        pf, hpf, p_ok = ortho_fn(pf, p_act, noise_floor, hblock=hpf,
                                 against=(x, wf), h_against=(hx, hwf),
                                 passes=ortho_passes, reduce_axis=red)

        basis_mask = torch.cat((ones, w_ok, p_ok), dim=-1).to(torch.float64)
        keep = basis_mask[..., :, None] * basis_mask[..., None, :]
        blocks, hblocks = (x, wf, pf), (hx, hwf, hpf)
        if use_f64_rr:
            rows = [[None] * 3 for _ in range(3)]
            for i, bi in enumerate(blocks):
                for j, hbj in enumerate(hblocks):
                    if rr_mirror and j < i:
                        continue
                    rows[i][j] = rr.gram_f64(bi, hbj, reduce_axis=red)
                    if rr_mirror and j > i:
                        rows[j][i] = rows[i][j].mH
        else:
            rows = [[rr.gram(bi, hbj, red) for hbj in hblocks]
                    for bi in blocks]
        t = rr.hermitize(torch.cat([torch.cat(row, -1) for row in rows], -2))
        del rows
        t = t * keep.to(real_dtype(t.dtype))
        # Dead-coordinate sentinel strictly below any Ritz value
        # (|Ritz| <= ||T||_F).
        dead_val = torch.linalg.vector_norm(t, dim=(-2, -1)) + 1.0
        t = t - dead_val[..., None, None] * torch.diag_embed(
            1.0 - basis_mask).to(t.dtype)
        if use_f64_rr:
            theta_all, c_all = rr.eigh_split(t, split)
        else:
            theta_all, c_all = rr.eigh(t)
        theta, c = _window(theta_all, c_all.to(cdtype), basis_mask, m)
        x, p = _block_update(c, m, blocks)
        hx, hp = _block_update(c, m, hblocks)
        lambdas = theta.to(rdtype)
        del wf, hwf, pf, hpf, blocks, hblocks
        it += 1

    out = []
    for lane, (lam, xl, its, status) in enumerate(done):
        if status == Status.RUNNING:
            status = (Status.NAN if bool(torch.isnan(lam).any())
                      else Status.MAXITER)
        tracing.count(STOP_COUNTERS[status])
        out.append(SolveResult(lambdas=lam - shift, x=xl.reshape(shape),
                               iterations=its, status=int(status),
                               res_history=trks[lane].res_his))
    return out


def _per_lane(value, n_lanes: int) -> list:
    """A per-lane option as a list of ``n_lanes`` values: a sequence of
    that length as it is, anything else repeated."""
    if isinstance(value, (list, tuple)):
        if len(value) != n_lanes:
            raise ValueError(f"{len(value)} per-lane values for {n_lanes} "
                             f"lanes")
        return list(value)
    return [value] * n_lanes


def lobpcg_sep_softlock(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """Soft-locking variant (reference: lobpcg.py:325-492, RECOMMENDED)."""
    kw.setdefault("locking", True)
    return lobpcg_sep(h_func, p_func, x0, nev, **kw)


def lobpcg_sep_nolock(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """No-locking variant (reference: lobpcg.py:76-193); its lane form is
    ``lobpcg_sep_lanes`` with ``locking=False``."""
    kw["locking"] = False
    return lobpcg_sep(h_func, p_func, x0, nev, **kw)


def descent_sep(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """Two-term preconditioned steepest descent: the [X | W] iteration
    without the conjugate block (reference: descent_sep, paper_2/
    lobpcg.py:847-974); its lane form is ``lobpcg_sep_lanes`` with
    ``use_p=False``."""
    kw["use_p"] = False
    return lobpcg_sep(h_func, p_func, x0, nev, **kw)


def lobpcg_sep_mixedprecision(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """Mixed precision: the preconditioner in complex64, everything else in
    the iterate's precision (reference: lobpcg.py:494-629); the one-lane
    case of ``lobpcg_sep_mixedprecision_lanes``."""
    res, = lobpcg_sep_mixedprecision_lanes(one_lane(h_func), one_lane(p_func),
                                           x0[None], nev, **kw)
    return res


def lobpcg_sep_mixedprecision_lanes(h_func, p_func, x0, nev, **kw) -> list:
    """``lobpcg_sep_mixedprecision`` on lanes: ``p_func(v, lanes)`` takes
    the block cast to complex64, its result is cast back."""
    cdtype = x0.dtype

    def p_low(v, lanes):
        return p_func(v.to(torch.complex64), lanes).to(cdtype)

    return lobpcg_sep_lanes(h_func, p_low, x0, nev, **kw)


_PENCILS = {"chol": rr.eigh_pencil, "whiten": rr.eigh_pencil_whiten,
            "embedding": rr.pencil_eigh}


def lobpcg_gep(
    h_func: Callable[[torch.Tensor], torch.Tensor],
    m_func: Callable[[torch.Tensor], torch.Tensor],
    p_func: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    nev: int,
    *,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    normalize: bool = True,
    use_p: bool = True,
    rr_pencil="auto",
    floor_patience: int = 0,
    f64_gram: bool = False,
    best_on_stop: bool = False,
) -> SolveResult:
    """LOBPCG for the generalized problem H x = lambda M x (M Hermitian
    positive definite): M-inner products in the Rayleigh-Ritz, residual
    R = lambda M X - H X, tested per column relative to the column's norm
    (``pcx.solvers.lobpcg.lobpcg_gep``).

    ``rr_pencil``: the small-pencil solver — ``"chol"`` (Cholesky
    reduction, reference GEP_chol), ``"embedding"`` (G-whitening by its
    inverse square root with dead directions sorted last: the JAX real
    embedding's algorithm, here in complex128), ``"whiten"``
    (``eigh_pencil_whiten``), a callable ``(T, G) -> (theta, C)``, or
    ``"auto"`` (embedding for complex64 iterates, chol otherwise).

    Three options carry the rules of the JAX pair twin ``lobpcg_gep_rs``
    (which sets them): ``floor_patience`` > 0 stops with FLOOR once the
    largest tracked residual has not improved 5% for that many
    iterations; ``f64_gram`` forms the pencil's Grams with complex128
    accumulation (``gram_f64``) instead of in the working precision;
    ``best_on_stop`` returns, on any stop but CONVERGED, the Ritz values of
    the best iteration instead of the last.
    """
    m = x0.shape[0]
    shape = x0.shape
    cdtype = x0.dtype
    rdtype = real_dtype(cdtype)
    dev = x0.device
    tiny = float(torch.finfo(rdtype).tiny ** 0.5)
    f = _NP_REAL[rdtype]
    if rr_pencil == "auto":
        rr_pencil = "embedding" if cdtype == torch.complex64 else "chol"
    pencil = rr_pencil if callable(rr_pencil) else _PENCILS[rr_pencil]
    gram = rr.gram_f64 if f64_gram else rr.gram

    def app(fn, a):
        return _flat(fn(a.reshape((-1,) + shape[1:])))

    def herm_gram(a, b):
        return rr.hermitize(gram(a, b))

    x = _flat(x0)
    if normalize:
        x, _ = col_normalize(x, tiny)
    hx, mx = app(h_func, x), app(m_func, x)
    theta0, c0 = pencil(herm_gram(x, hx), herm_gram(x, mx))
    c0 = c0.to(cdtype)
    x, hx, mx = rr.mix(c0, x), rr.mix(c0, hx), rr.mix(c0, mx)
    lambdas = theta0.real.to(rdtype)
    best_lambdas = lambdas
    p, hp, mp = (torch.zeros_like(x) for _ in range(3))
    ones_m = torch.ones((m,), dtype=rdtype, device=dev)

    res_his = np.full((maxiter,), np.nan, f)
    best_res, best_it = f(np.inf), 0
    it = 0
    status = Status.RUNNING
    while it < maxiter:
        r = lambdas.to(cdtype)[:, None] * mx - hx
        res_t = rr.colnorms(r) / rr.colnorms(x).clamp(min=tiny)
        host = torch.cat((res_t, lambdas)).cpu().numpy()
        res = host[:m]
        if it > 0 and np.isnan(host[m:]).any():
            status = Status.NAN
            break
        res_max = np.max(res[:nev])
        res_his[it] = np.sqrt(np.sum(res[:nev] * res[:nev], dtype=f))
        if res_max < best_res * f(0.95):
            best_res, best_it, best_lambdas = res_max, it, lambdas
        floored = (floor_patience > 0 and it > 3
                   and it - best_it > floor_patience)
        if np.isnan(res).any():
            status = Status.NAN
        elif res_max < tol:
            status = Status.CONVERGED
        elif floored:
            status = Status.FLOOR
        if status != Status.RUNNING:
            break

        active = (torch.as_tensor(res > tol, device=dev).to(rdtype)
                  if locking else ones_m)
        acol = active[:, None]
        w = app(p_func, acol * r) * acol
        if normalize:
            w, _ = col_normalize(w, tiny)
        hw, mw = app(h_func, w), app(m_func, w)
        p_act = active * (1.0 if it > 0 and use_p else 0.0)
        pcol = p_act[:, None]
        blocks = (x, w, pcol * p)
        hblocks = (hx, hw, pcol * hp)
        mblocks = (mx, mw, pcol * mp)
        s_all = torch.cat(blocks)
        basis_mask = torch.cat((ones_m, active, p_act)).to(torch.float64)
        keep = basis_mask[:, None] * basis_mask[None, :]
        dead = torch.diag(1.0 - basis_mask)
        g = herm_gram(s_all, torch.cat(mblocks))
        keep = keep.to(real_dtype(g.dtype))
        g = g * keep + dead.to(g.dtype)
        gh = herm_gram(s_all, torch.cat(hblocks)) * keep
        del s_all
        dead_val = torch.linalg.norm(gh) + 1.0
        gh = gh - dead_val * dead.to(gh.dtype)
        theta_all, c_all = pencil(gh, g)
        theta, c = _window(theta_all.real, c_all.to(cdtype), basis_mask, m)
        x, p = _block_update(c, m, blocks)
        hx, hp = _block_update(c, m, hblocks)
        mx, mp = _block_update(c, m, mblocks)
        lambdas = theta.to(rdtype)
        del w, hw, mw, blocks, hblocks, mblocks
        it += 1

    if status == Status.RUNNING:
        status = (Status.NAN if bool(torch.isnan(lambdas).any())
                  else Status.MAXITER)
    if best_on_stop and status != Status.CONVERGED:
        lambdas = best_lambdas
    return SolveResult(lambdas=lambdas, x=x.reshape(shape), iterations=it,
                       status=int(status), res_history=res_his)


def lobpcg_sep_max(h_func, x0, nev, *, tol: float = TOL,
                   maxiter: int = MAXITER, rr_pencil="auto") -> SolveResult:
    """Largest eigenvalues of H through the inverse formulation x = mu H x
    (mu = 1/lambda smallest), solved as the pencil I x = mu H x by
    ``lobpcg_gep`` without locking (reference: lobpcg_sep_max_nolock,
    paper_2/lobpcg.py:196-323)."""
    res = lobpcg_gep(lambda v: v, h_func, lambda v: v, x0, nev, tol=tol,
                     maxiter=maxiter, locking=False, rr_pencil=rr_pencil)
    return res._replace(lambdas=1.0 / res.lambdas)


def descent_gep(h_func, m_func, p_func, x0, nev, **kw) -> SolveResult:
    """Two-term steepest descent for the generalized problem (reference:
    descent_gep, paper_2/lobpcg.py:976-1100)."""
    kw["use_p"] = False
    return lobpcg_gep(h_func, m_func, p_func, x0, nev, **kw)


def lobpcg_default(a, nev: int = 20, rlx: int = 4, prec=None,
                   maxmin: str = "min", tol: float = TOL,
                   maxiter: int = MAXITER, seed: int = 0, *,
                   device="cuda") -> SolveResult:
    """Smallest (``maxmin="min"``) or largest (``"max"``) eigenvalues of an
    explicit Hermitian operator (reference: lobpcg_default, paper_2/
    lobpcg.py:28-61).

    ``a`` is a dense matrix (a tensor or an array, moved to ``device``) or
    a ``(function, size)`` tuple whose function maps one vector to its
    image.  The start block, nev + rlx random vectors, comes from
    ``numpy.random.default_rng(seed)`` as in the JAX package.
    """
    if isinstance(a, tuple):
        h_vec, n = a

        def h_func(block):
            return torch.stack([h_vec(v) for v in block])

        dt = torch.complex128
    else:
        a = torch.as_tensor(a, device=device)
        n = a.shape[0]
        at = a.T

        def h_func(block):
            return block @ at.to(block.dtype)

        dt = a.dtype
    cdt = torch.promote_types(dt, torch.complex64)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(size=(nev + rlx, n))
                         + 1j * rng.uniform(size=(nev + rlx, n))).to(
                             device=device, dtype=cdt)
    p_func = (lambda v: v) if prec is None else prec
    if maxmin == "min":
        return lobpcg_sep_softlock(h_func, p_func, x0, nev, tol=tol,
                                   maxiter=maxiter)
    if maxmin == "max":
        return lobpcg_sep_max(h_func, x0, nev, tol=tol, maxiter=maxiter)
    raise ValueError("maxmin should be 'min' or 'max'.")


def lobpcg_svd(a_func: Callable, at_func: Callable, x0: torch.Tensor,
               nev: int, p_func: Optional[Callable] = None,
               largest: bool = False, tol: float = TOL,
               maxiter: int = MAXITER) -> SolveResult:
    """Extreme singular triplets of a linear operator K through the
    Hermitian problem K^H K v = sigma^2 v: right singular vectors from
    LOBPCG on the normal operator, singular values the square roots of its
    Ritz values (the reference's lobpcg4svd_sep, paper_2/lobpcg.py:
    1102-1242, is incomplete; this is the JAX package's working form)."""
    h = lambda v: at_func(a_func(v))   # noqa: E731
    if largest:
        res = lobpcg_sep_max(h, x0, nev, tol=tol, maxiter=maxiter)
    else:
        res = lobpcg_sep_softlock(h, p_func or (lambda v: v), x0, nev,
                                  tol=tol, maxiter=maxiter)
    return res._replace(lambdas=torch.sqrt(res.lambdas.clamp(min=0.0)))

