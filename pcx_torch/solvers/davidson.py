"""Block Davidson and Jacobi-Davidson eigensolvers.

Port of ``pcx/solvers/davidson.py`` (reference: paper_1_python/
eigen_solver.py:848-983 davidson_sep, :985-1124 jd_sep).  The subspace has
a fixed capacity: its basis V and H V live in two (cap, ...) blocks whose
first ``n_fill`` rows are filled; each iteration appends the orthonormal
new directions, and when the next ones would not fit the basis restarts
from the current Ritz block.  The Jacobi-Davidson variant expands with
approximate solutions of the projected correction equation
    (I - X X^H)(H - theta)(I - X X^H) t = -r
by a fixed number of preconditioned CG steps.

The JAX package keeps the fill as a 0/1 mask and decouples the empty rows
of its Rayleigh-Ritz matrix at a sentinel below the spectrum; here the
fill count is a host integer (one read-back per iteration besides the
residuals') and the Grams run over the filled rows only, with the small
matrix padded back to the capacity and decoupled the same way, so the
small eigenproblem is the JAX one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pcx_torch.config import MAXITER, N_SUBSPACE, TOL
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.solvers.lobpcg import (SolveResult, Status, _NP_REAL,
                                      col_normalize)
from pcx_torch.utils import dots, real_dtype


def _davidson(h_func: Callable, p_func: Callable, x0: torch.Tensor, nev: int,
              correction: str, tol: float, maxiter: int, cap: int,
              inner_steps: int) -> SolveResult:
    m = x0.shape[0]
    shape = x0.shape
    cdtype = x0.dtype
    rdtype = real_dtype(cdtype)
    dev = x0.device
    finfo = torch.finfo(rdtype)
    tiny = float(finfo.tiny ** 0.5)
    jitter = 100.0 * float(finfo.eps)
    f = _NP_REAL[rdtype]

    def hf(a: torch.Tensor) -> torch.Tensor:
        return h_func(a.reshape((-1,) + shape[1:])).reshape(a.shape[0], -1)

    def pf(a: torch.Tensor) -> torch.Tensor:
        return p_func(a.reshape(shape)).reshape(m, -1)

    # ---- init: orthonormal X, Ritz-rotated ------------------------------
    x, _ = col_normalize(x0.reshape(m, -1), tiny)
    xf, _ = rr.masked_loewdin(x, torch.ones((m,), dtype=rdtype, device=dev),
                              jitter)
    hxf = hf(xf)
    theta0, v0 = rr.eigh_split(rr.hermitize(rr.gram_f64(xf, hxf)), 1e-10)
    c0 = v0.to(cdtype)
    x, hx = rr.mix(c0, xf), rr.mix(c0, hxf)
    lambdas = theta0.to(rdtype)
    del xf, hxf

    v = torch.zeros((cap, x.shape[1]), dtype=cdtype, device=dev)
    hv = torch.zeros_like(v)
    v[:m], hv[:m] = x, hx
    n_fill = m

    def correction_block(r, x, lambdas):
        """New search directions from the residual block."""
        if correction == "davidson":
            return pf(r)       # preconditioned Davidson correction t = P r

        def proj(z):
            return rr.combine((x,), (rr.gram(x, z),), z, subtract=True)

        lam = lambdas.to(cdtype)[:, None]

        def a_op(z):
            pz = proj(z)
            return proj(hf(pz) - lam * pz)

        def safe(d):
            return torch.where(d.abs() > tiny, d, torch.ones_like(d))

        # CG from t = 0: the first residual is b itself (A 0 = 0 exactly,
        # the JAX loop spends one operator apply to find that out).
        res = proj(-r)
        t = torch.zeros_like(res)
        z = proj(pf(res))
        p = z
        rz = dots(res, z).real
        for _ in range(inner_steps):
            ap = a_op(p)
            alpha = (rz / safe(dots(p, ap).real)).to(cdtype)[:, None]
            t = t + alpha * p
            res = res - alpha * ap
            z = proj(pf(res))
            rz_new = dots(res, z).real
            beta = (rz_new / safe(rz)).to(cdtype)[:, None]
            p = z + beta * p
            rz = rz_new
        return t

    res_his = np.full((maxiter,), np.nan, f)
    it = 0
    status = Status.RUNNING
    while it < maxiter:
        r = lambdas.to(cdtype)[:, None] * x - hx
        host = torch.cat((rr.colnorms(r), lambdas)).cpu().numpy()
        res = host[:m]
        res_his[it] = np.sqrt(np.sum(res[:nev] * res[:nev], dtype=f))
        if np.isnan(res).any():
            status = Status.NAN
        elif np.max(res[:nev]) < tol:
            status = Status.CONVERGED
        if status != Status.RUNNING:
            break

        if n_fill + m > cap:          # restart from the current Ritz block
            v[:m], hv[:m] = x, hx
            n_fill = m

        # New directions: the correction block, projected off the filled
        # basis, the dependent ones dropped, Loewdin-orthonormalized.
        t, _ = col_normalize(correction_block(r, x, lambdas), tiny)
        t, _ = rr.project_off(t, v[:n_fill])
        ok = (rr.colnorms(t) > 1e3 * float(finfo.eps)).to(rdtype)
        t, _ = rr.masked_loewdin(t * ok[:, None], ok, jitter, passes=2)
        ht = hf(t)
        live = ok.cpu().numpy() > 0
        n_new = int(live.sum())
        if n_new:
            sel = torch.as_tensor(np.flatnonzero(live), device=dev)
            v[n_fill:n_fill + n_new] = t[sel]
            hv[n_fill:n_fill + n_new] = ht[sel]
            n_fill += n_new
        del t, ht

        # Rayleigh-Ritz over the filled basis, in the capacity-sized matrix
        # of the JAX loop: the empty rows decoupled below the spectrum.
        tm = torch.zeros((cap, cap), dtype=torch.complex128, device=dev)
        tm[:n_fill, :n_fill] = rr.hermitize(rr.gram_f64(v[:n_fill],
                                                        hv[:n_fill]))
        dead_val = torch.linalg.norm(tm) + 1.0
        empty = torch.arange(cap, device=dev) >= n_fill
        tm = tm - dead_val * torch.diag(empty.to(torch.complex128))
        theta_all, u = rr.eigh_split(tm, 1e-10)
        n_dead = cap - n_fill
        c = u[:n_fill, n_dead:n_dead + m].to(cdtype)
        lambdas = theta_all[n_dead:n_dead + m].to(rdtype)
        x, hx = rr.mix(c, v[:n_fill]), rr.mix(c, hv[:n_fill])
        it += 1

    if status == Status.RUNNING:
        status = Status.MAXITER
    return SolveResult(lambdas=lambdas, x=x.reshape(shape), iterations=it,
                       status=int(status), res_history=res_his)


def _complex_start(x0):
    """A (re, im) pair start (the JAX twins' TPU layout) as one complex
    tensor; the operator functions take complex blocks either way."""
    return torch.complex(*x0) if isinstance(x0, tuple) else x0


def davidson_sep(h_func, p_func, x0, nev, tol: float = TOL,
                 maxiter: int = MAXITER, subspace: int = N_SUBSPACE,
                 **_) -> SolveResult:
    """Preconditioned block Davidson with a basis of max(subspace, 3m)
    vectors (reference: davidson_sep, paper_1_python/eigen_solver.py:
    848-983).  Other keywords are ignored, as in the JAX package."""
    x0 = _complex_start(x0)
    return _davidson(h_func, p_func, x0, nev, "davidson", tol, maxiter,
                     max(subspace, 3 * x0.shape[0]), 0)


def jd_sep(h_func, p_func, x0, nev, tol: float = TOL,
           maxiter: int = MAXITER, subspace: int = N_SUBSPACE,
           inner_steps: int = 5, **_) -> SolveResult:
    """Block Jacobi-Davidson with the correction equation solved by
    ``inner_steps`` preconditioned CG steps (reference: jd_sep,
    paper_1_python/eigen_solver.py:985-1124)."""
    x0 = _complex_start(x0)
    return _davidson(h_func, p_func, x0, nev, "jd", tol, maxiter,
                     max(subspace, 3 * x0.shape[0]), inner_steps)
