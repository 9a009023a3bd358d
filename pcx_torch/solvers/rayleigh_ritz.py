"""Dense local algebra of the eigensolvers: Grams, mixes, the masked
orthonormalizers (SVQB with column dropping, MGS, Loewdin, Cholesky-QR),
the small Hermitian eigenproblems and pencils, and the power method.

Port of ``pcx/solvers/rayleigh_ritz.py`` (and ``rs.pencil_f64_embedding``).
Blocks of vectors are (p, D) complex tensors, the vector index first.
The helpers of the LOBPCG bodies (``gram_f64``, ``gram``, ``mix``,
``colnorms``, ``scale_cols``, ``hermitize``, ``eigh_split``,
``masked_svqb_drop``, and for the complex family ``masked_loewdin``,
``rayleigh_ritz`` and ``masked_mgs``) also take a leading lane axis,
(L, p, D) blocks with (L, p) masks, for the lockstep k-point batch
(``lobpcg_rs.lobpcg_sep_rs_lanes``, ``lobpcg.lobpcg_sep_lanes``): each
lane's result is the 2-D call's on that lane, and a small Hermitian
problem or Cholesky factor of every lane is one ``torch.linalg`` call.

The JAX package solves its small Hermitian problems through a real f64
embedding with emulated-f64 repairs, because the TPU has no complex128.  On
the card complex128 is native, so ``eigh_split`` is ``torch.linalg.eigh`` on
complex128 with the same graded degeneracy split (``split_for``), which
decides which directions SVQB drops.

``reduce_axis`` (pcx's ``axis_name``) is the process group over which the
long dimension D of the blocks is sharded: ``gram``, ``gram_f64``, the
orthonormalizers and ``rayleigh_ritz`` all-reduce every partial Gram and
sum of squares over it before using it (JAX's ``psum``); None, the
default, changes nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pcx_torch.utils import all_reduce_sum, norms, real_dtype

C128 = torch.complex128

# Columns per partial of the Grams.  A single-precision GEMM accumulates
# its k dimension in single precision, so a partial's rounding error grows
# with sqrt(chunk).  On an H100 a (16, 3*120^3) complex64 Gram carried
# 5.3e-6 relative error against complex128 at 65536 columns per partial
# and 3.6e-6 as one GEMM, where the CPU's blocked GEMM keeps ~3e-7; that
# error, times the penalty eigenvalues in the Rayleigh-Ritz matrix, set
# the complex64 residual floor of the solvers on the card (PERF.md, F3).
GRAM_CHUNK = 256


def hermitize(a: torch.Tensor) -> torch.Tensor:
    """(A + A^H) / 2."""
    return 0.5 * (a + a.mH)


def divisor_chunk(d: int, target: int) -> int:
    """Largest Gram chunk <= target that divides d (so the chunked view needs
    no padding); ``target`` when d has no divisor near it."""
    lo = -(-d // target)
    for nc in range(lo, min(d, 4 * lo) + 1):
        if d % nc == 0:
            return d // nc
    return target


def gram_f64(x: torch.Tensor, y: torch.Tensor, chunk: int = 0,
             reduce_axis=None) -> torch.Tensor:
    """G[i, j] = <x_i, y_j> (complex128; float64 for real blocks) for
    row-blocks x (..., p, D), y (..., q, D), as working-precision partials
    over D-chunks summed in double: the error grows with sqrt(chunk), not
    sqrt(D) (twin of ``rayleigh_ritz.gram_f64_p``).  ``chunk=0`` picks
    ``divisor_chunk(D, GRAM_CHUNK)``; the double sum is all-reduced over
    ``reduce_axis``.  Lanes (L, p, D) take one batched GEMM each: the
    chunked view of a lane is a strided batch, that of all lanes is not,
    and one GEMM over them would copy both operands."""
    if x.dim() > 2:
        return torch.stack([gram_f64(a, b, chunk, reduce_axis)
                            for a, b in zip(x, y)])
    p, d = x.shape
    q = y.shape[0]
    chunk = chunk or divisor_chunk(d, GRAM_CHUNK)
    nc = -(-d // chunk)
    pad = nc * chunk - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    xc = x.view(p, nc, chunk).transpose(0, 1)
    yc = y.view(q, nc, chunk).transpose(0, 1)
    # conj(G_c) = X_c Y_c^H: the conjugate rides on the transposed operand.
    part = torch.matmul(xc, yc.mH)
    acc = C128 if part.is_complex() else torch.float64
    g = all_reduce_sum(part.sum(dim=0, dtype=acc), reduce_axis)
    return torch.conj_physical(g)


def gram(x: torch.Tensor, y: torch.Tensor, reduce_axis=None) -> torch.Tensor:
    """The Gram conj(X) Y^T (p, q) in the working precision, for
    projections (twin of ``rayleigh_ritz.gram_p32``): ``gram_f64``
    rounded, as one GEMM over all of D loses digits on the card."""
    return gram_f64(x, y, reduce_axis=reduce_axis).to(x.dtype)


def mix(c: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """out_j = sum_i c[i, j] blocks_i; c (..., p, q), blocks (..., p, D) ->
    (..., q, D) (twin of ``rayleigh_ritz.mix_pair``)."""
    return torch.matmul(c.transpose(-2, -1), blocks)


def colnorms(x: torch.Tensor, reduce_axis=None,
             lanes: bool = False) -> torch.Tensor:
    """Per-vector 2-norms of a block (m, ...) -> (m,) (twin of
    ``rayleigh_ritz.colnorms_p``); with ``lanes``, of an (L, m, ...)
    block -> (L, m)."""
    if lanes:
        return norms(x.flatten(0, 1), reduce_axis).view(x.shape[:2])
    return norms(x, reduce_axis)


def scale_cols(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Each vector of x scaled by its entry of s: the shape of s is that of
    x's leading axes ((m,) for a block, (L, m) for lanes)."""
    return x * s.reshape(s.shape + (1,) * (x.dim() - s.dim())).to(
        real_dtype(x.dtype))


def split_for(rdtype: torch.dtype, svqb: bool = False) -> float:
    """Degeneracy split of ``eigh_split`` by the ITERATE dtype: f32 Gram
    entries carry ~eps_f32 noise that the graded perturbation must dominate
    (1e-7); f64 iterates take 1e-10 (Rayleigh-Ritz) / 1e-12 (SVQB Grams).
    See ``rayleigh_ritz.split_for`` for the measured rationale."""
    if rdtype == torch.float32:
        return 1e-7
    return 1e-12 if svqb else 1e-10


def eigh_split(t: torch.Tensor, split: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending eigenpairs of a Hermitian complex128 matrix after a graded
    diagonal perturbation of size ``split * scale`` that separates degenerate
    eigenvalues deterministically (kept in the returned eigenvalues, as in
    ``rayleigh_ritz.eigh_f64_embedding``)."""
    p = t.shape[-1]
    scale = _absmax(t.real) + _absmax(t.imag) + 1e-30
    pert = split * scale[..., None] * torch.arange(p, dtype=torch.float64,
                                                   device=t.device) / p
    return torch.linalg.eigh(t + torch.diag_embed(pert).to(C128))


def _absmax(a: torch.Tensor) -> torch.Tensor:
    """max |a| over the last two axes (the whole matrix, each lane's)."""
    return a.abs().amax(dim=(-2, -1))


def masked_svqb_drop(block: torch.Tensor, mask: torch.Tensor,
                     drop_tol: float, hblock: Optional[torch.Tensor] = None,
                     against: Sequence[torch.Tensor] = (),
                     h_against: Sequence[torch.Tensor] = (),
                     passes: int = 2, reduce_axis=None):
    """SVQB orthonormalization with dependent-direction DROPPING
    (twin of ``rayleigh_ritz.masked_svqb_drop_p``).

    Per pass: project off the orthonormal rows of ``against`` (working
    precision), form the complex128-accumulated Gram of the masked block;
    on the first pass eigendecompose it and drop directions with eigenvalue
    below max(drop_tol^2, lam_fac * split * gscale) (zeroed and masked out,
    never jitter-inflated), scaling the rest by 1/sqrt(eigenvalue); later
    passes are Gram Newton-Schulz steps (3 diag(mask) - G) / 2.
    ``hblock``/``h_against`` follow the same combinations.  Returns
    (q, hq, new_mask) with the mask in the real dtype.  Lanes: blocks
    (L, p, D) with an (L, p) mask, each lane with its own drop threshold."""
    cdtype = block.dtype
    rdtype = real_dtype(cdtype)
    mask = mask.to(torch.float64)
    split = split_for(rdtype, svqb=True)
    lam_fac = 10.0 if rdtype == torch.float32 else 1e3
    hb = hblock
    if len(against) > 1:
        against = (torch.cat(tuple(against), dim=-2),)
        if h_against:
            h_against = (torch.cat(tuple(h_against), dim=-2),)
    pairs = list(zip(against, h_against or [None] * len(against)))
    for pno in range(passes):
        for base, hbase in pairs:
            coeff = gram(base, block, reduce_axis)
            block = block - mix(coeff, base)
            if hb is not None and hbase is not None:
                hb = hb - mix(coeff, hbase)
        keep = mask[..., :, None] * mask[..., None, :]
        g = hermitize(gram_f64(block, block, reduce_axis=reduce_axis)) * keep
        if pno == 0:
            gscale = _absmax(g.real) + _absmax(g.imag)
            lam_min = torch.clamp(lam_fac * split * gscale,
                                  min=float(drop_tol) ** 2)[..., None]
            w, v = eigh_split(g, split)
            ok = (w > lam_min).to(torch.float64)
            coeff = (v * (ok / torch.sqrt(torch.maximum(w, lam_min))
                          )[..., None, :]).to(cdtype)
            mask = ok
        else:
            coeff = (1.5 * torch.diag_embed(mask) - 0.5 * g).to(cdtype)
        block = mix(coeff, block)
        if hb is not None:
            hb = mix(coeff, hb)
    return block, hb, mask.to(rdtype)


def pencil_eigh(t: torch.Tensor, g: torch.Tensor, split: float = 1e-12
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """theta, C solving the Hermitian-definite pencil T C = theta G C in
    complex128 (replaces ``rs.pencil_f64_embedding``).

    G is whitened by its eigh-based inverse square root; numerically dead
    directions (lambda_G <= 1e-12 max) get zero weight and their Ritz slot is
    bumped above the spectrum so they sort last, never as below-spectrum
    phantoms."""
    g = hermitize(g)
    t = hermitize(t)
    m = t.shape[0]
    lam, u = torch.linalg.eigh(g)
    alive = lam > 1e-12 * lam.max()
    inv_sqrt = torch.where(alive, 1.0 / torch.sqrt(lam.clamp(min=1e-30)),
                           torch.zeros_like(lam))
    s = (u * inv_sqrt.to(C128)) @ u.mH
    tw = hermitize(s @ t @ s)
    scale = torch.maximum(tw.real.abs().max(), tw.imag.abs().max()) + 1e-30
    pert = split * scale * torch.arange(m, dtype=torch.float64,
                                        device=t.device) / m
    dead = 1.0 - torch.diagonal(s @ g @ s).real
    bump = 2.0 * scale * (dead > 0.5).to(torch.float64)
    theta, v = torch.linalg.eigh(tw + torch.diag(pert + bump).to(C128))
    return theta, s @ v


def _tri_solve(l: torch.Tensor, b: torch.Tensor, upper: bool = False
               ) -> torch.Tensor:
    return torch.linalg.solve_triangular(l, b, upper=upper)


def short_qr(x: torch.Tensor) -> torch.Tensor:
    """Orthonormalize a row-block via Cholesky-QR
    (reference: orthogonalization.py:36-46)."""
    l = torch.linalg.cholesky(hermitize(gram(x, x)))
    return _tri_solve(l, x)


def eigh_pencil(t: torch.Tensor, g: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the Hermitian-definite pencil T v = theta G v by Cholesky
    reduction to a standard Hermitian eigenproblem
    (reference: GEP_chol, orthogonalization.py:99-115)."""
    l = torch.linalg.cholesky(g)
    t1 = _tri_solve(l, t)
    t2 = _tri_solve(l, t1.mH).mH
    theta, q = torch.linalg.eigh(hermitize(t2))
    return theta, _tri_solve(l.mH, q, upper=True)   # v = L^{-H} q


def eigh_pencil_whiten(t: torch.Tensor, g: torch.Tensor, split: float = 1e-10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pencil T v = theta G v by G-whitening: S = G^(-1/2) from the
    split eigh of G, the split eigh of S T S, C = S V.  Numerically dead
    directions (zero G rows: masked basis columns) get zero whitening weight
    and their Ritz slot bumped above the spectrum, so they sort last
    (``rayleigh_ritz.eigh_pencil_whiten``, in complex128 instead of the
    real embedding).  Returns theta in the real dtype of ``t``."""
    t128, g128 = hermitize(t).to(C128), hermitize(g).to(C128)
    wg, u = eigh_split(g128, 1e-12)
    alive = wg > 1e-12 * wg.max()
    inv = torch.where(alive, 1.0 / torch.sqrt(wg.clamp(min=1e-30)),
                      torch.zeros_like(wg))
    s = (u * inv.to(C128)) @ u.mH
    tw = s @ t128 @ s
    sgs = torch.diagonal(s @ g128 @ s).real
    scale = tw.real.abs().max() + tw.imag.abs().max() + 1e-30
    bump = 2.0 * scale * (sgs < 0.5).to(torch.float64)
    theta, v = eigh_split(hermitize(tw) + torch.diag(bump).to(C128), split)
    return theta.to(real_dtype(t.dtype)), (s @ v).to(t.dtype)


def rayleigh_ritz(s: torch.Tensor, hs: torch.Tensor, reduce_axis=None):
    """Plain Rayleigh-Ritz on a row-block: Ritz values and vectors of H in
    span(s) (reference: rayleigh_ritz_chol_sep, orthogonalization.py:
    140-154).  Lanes: (L, p, D) blocks, one batched Cholesky and eigh."""
    return eigh_pencil(hermitize(gram(s, hs, reduce_axis)),
                       hermitize(gram(s, s, reduce_axis)))


def masked_loewdin(block: torch.Tensor, mask: torch.Tensor, jitter: float,
                   hblock: Optional[torch.Tensor] = None, passes: int = 1,
                   reduce_axis=None):
    """Loewdin (symmetric) orthonormalization of the active rows: Q =
    mix(S, B), S = (G + pad)^(-1/2) from the complex128-accumulated Gram,
    its eigenvalues clamped at ``jitter`` times the largest.  Masked-out
    rows must be zero; the padded Gram diagonal keeps them zero.  Lanes:
    (L, p, D) blocks with an (L, p) mask, each lane clamped at its own
    largest eigenvalue."""
    mask64 = mask.to(torch.float64)
    keep = mask64[..., :, None] * mask64[..., None, :]
    dead = torch.diag_embed(1.0 - mask64)
    rmask = mask.to(real_dtype(block.dtype))[..., None]
    for _ in range(passes):
        g = (hermitize(gram_f64(block, block, reduce_axis=reduce_axis))
             * keep + dead)
        w, v = eigh_split(g, 1e-10)
        w = torch.maximum(w, jitter * w[..., -1:].clamp(min=1e-30))
        s = ((v * (1.0 / torch.sqrt(w))[..., None, :]) @ v.mH).to(
            block.dtype)
        block = mix(s, block) * rmask
        if hblock is not None:
            hblock = mix(s, hblock) * rmask
    return block, hblock


def masked_mgs(block: torch.Tensor, mask: torch.Tensor, drop_tol: float,
               hblock: Optional[torch.Tensor] = None,
               against: Sequence[torch.Tensor] = (),
               h_against: Sequence[torch.Tensor] = (), passes: int = 2,
               reduce_axis=None):
    """Masked modified Gram-Schmidt with dependent-column dropping: the
    active rows are projected off the orthonormal rows of each ``against``
    base, then orthonormalized one after another; a row whose residual
    norm falls below ``drop_tol`` is zeroed and masked out.  ``hblock``/
    ``h_against`` follow the same combinations.  Returns (q, hq, mask)
    with the mask in the real dtype.  Lanes: (L, p, D) blocks with an
    (L, p) mask; row i of every lane is taken in one step."""
    m = block.shape[-2]
    lanes = block.dim() > 2
    rdtype = real_dtype(block.dtype)
    tiny = torch.finfo(rdtype).tiny
    msk = mask.to(rdtype).clone()
    for base, hbase in zip(against, h_against or [None] * len(against)):
        for _ in range(passes):
            coeff = gram(base, block, reduce_axis)
            block = block - mix(coeff, base)
            if hblock is not None and hbase is not None:
                hblock = hblock - mix(coeff, hbase)
    q = block.clone()
    hq = hblock.clone() if hblock is not None else None
    idx = torch.arange(m, device=block.device)
    for i in range(m):
        col = q[..., i:i + 1, :]
        hcol = hq[..., i:i + 1, :] if hq is not None else None
        wsel = ((idx < i).to(rdtype) * msk)[..., None]
        for _ in range(passes):
            coeff = gram(q, col, reduce_axis) * wsel
            col = col - mix(coeff, q)
            if hq is not None:
                hcol = hcol - mix(coeff, hq)
        nrm = colnorms(col, reduce_axis, lanes=lanes)[..., 0]
        ok = msk[..., i] * (nrm > drop_tol).to(rdtype)
        scale = (ok / nrm.clamp(min=tiny))[..., None]
        q[..., i, :] = col[..., 0, :] * scale
        if hq is not None:
            hq[..., i, :] = hcol[..., 0, :] * scale
        msk[..., i] = ok
    return q, hq, msk


def masked_cholqr(block: torch.Tensor, mask: torch.Tensor, jitter: float,
                  hblock: Optional[torch.Tensor] = None, passes: int = 1):
    """Cholesky-QR of the active rows (``passes=2``: CholQR2).  Masked-out
    rows must be zero and stay zero (their Gram diagonal is padded with 1);
    ``jitter`` times the largest Gram diagonal regularizes the factor.
    ``hblock`` follows the same row combinations."""
    keep = (mask[:, None] * mask[None, :]).to(block.dtype)
    dead = torch.diag(1.0 - mask).to(block.dtype)
    rmask = mask.to(real_dtype(block.dtype))[:, None]
    eye = torch.eye(block.shape[0], dtype=block.dtype, device=block.device)
    for _ in range(passes):
        g = hermitize(gram(block, block)) * keep + dead
        g = g + jitter * torch.diagonal(g).abs().max() * eye
        lc = torch.linalg.cholesky(g).conj()
        # Row convention: Q = conj(L)^{-1} B, so conj(Q) Q^T = I.
        block = _tri_solve(lc, block) * rmask
        if hblock is not None:
            hblock = _tri_solve(lc, hblock) * rmask
    return block, hblock


def project_off(block: torch.Tensor, basis: torch.Tensor,
                hblock: Optional[torch.Tensor] = None,
                hbasis: Optional[torch.Tensor] = None):
    """Project the rows of ``block`` off the orthonormal rows of ``basis``
    (and apply the same combination to ``hblock`` with ``hbasis``)."""
    coeff = gram(basis, block)
    block = block - mix(coeff, basis)
    if hblock is not None:
        hblock = hblock - mix(coeff, hbasis)
    return block, hblock


def power_method(a_func, x0: torch.Tensor, maxiter: int = 1000,
                 tol: float = 1e-5):
    """Largest eigenvalue by the power method (reference:
    orthogonalization.py:57-85): returns (lambda, x, iterations), lambda
    a 0-d tensor of the real dtype.  The stopping test reads one scalar
    back to the host per step."""
    x = x0 / torch.linalg.vector_norm(x0)
    lam = torch.zeros((), dtype=real_dtype(x0.dtype), device=x0.device)
    i = 0
    while i < maxiter:
        ax = a_func(x)
        lam = torch.linalg.vector_norm(ax)
        res = (ax - lam * x).abs().max() / lam.abs()
        x = ax / lam
        i += 1
        if not bool(res > tol):
            break
    return lam, x, i
