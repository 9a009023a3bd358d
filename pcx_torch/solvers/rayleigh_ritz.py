"""Dense local algebra of the eigensolvers: Grams, mixes, the masked
orthonormalizers (SVQB with column dropping, MGS, Loewdin, Cholesky-QR),
the small Hermitian eigenproblems and pencils, and the power method.

Port of ``pcx/solvers/rayleigh_ritz.py`` (and ``rs.pencil_f64_embedding``).
Blocks of vectors are (p, D) complex tensors, the vector index first.
The helpers of the LOBPCG bodies (``gram_f64``, ``gram``, ``combine``,
``mix``, ``colnorms``, ``scale_cols``, ``hermitize``, ``eigh_split``,
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

from pcx_torch import tracing
from pcx_torch.kernels.block_combine import (MAX_Q, MAX_ROWS, block_combine,
                                             block_combine_plain)
from pcx_torch.kernels.gram_chunks import (MAX_SIDE as GRAM_MAX_SIDE,
                                           gram_chunks, gram_chunks_plain)
from pcx_torch.utils import all_reduce_sum, norms, real_dtype

C128 = torch.complex128


def hermitize(a: torch.Tensor) -> torch.Tensor:
    """(A + A^H) / 2."""
    return 0.5 * (a + a.mH)


def _blocks(x) -> tuple:
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _gram(x, y, chunk: int, reduce_axis, rounded: bool) -> torch.Tensor:
    """The Gram of ``gram_f64``, rounded to the blocks' dtype with
    ``rounded``.  Routed by dtype, device and size alone: on the card a
    complex64 call within kernel K6's row limits is one launch of K6, which
    reads the blocks where they lie, or raises where K6 cannot read an
    operand (counter ``dense.gram``); a complex64 call past those limits
    is K6's plain version (``dense.gram_plain``), as is a call in another
    dtype (complex128: the refine, ``f64_truth``) and every CPU call."""
    xs, ys = _blocks(x), _blocks(y)
    b0 = xs[0]
    dtype = b0.dtype
    if b0.is_cuda and dtype == torch.complex64:
        if (sum(b.shape[-2] for b in xs) <= GRAM_MAX_SIDE
                and sum(b.shape[-2] for b in ys) <= GRAM_MAX_SIDE):
            # the kernel rounds, unless the sum is all-reduced first
            in_kernel = rounded and reduce_axis is None
            g = gram_chunks(xs, ys, chunk, c64=in_kernel)
            tracing.count("dense.gram")
            if in_kernel:
                return g
            g = all_reduce_sum(g, reduce_axis)
            return g.to(dtype) if rounded else g
        tracing.count("dense.gram_plain")
    g = all_reduce_sum(gram_chunks_plain(xs, ys, chunk), reduce_axis)
    return g.to(dtype) if rounded else g


def gram_f64(x, y, chunk: int = 0, reduce_axis=None) -> torch.Tensor:
    """G[i, j] = <x_i, y_j> (complex128; float64 for real blocks) for
    row-blocks x (..., p, D), y (..., q, D), or for sequences of row-blocks
    taken as stacked (the stack is not built on the card), as
    working-precision partials over D-chunks summed in double: the error
    grows with sqrt(chunk), not sqrt(D) (twin of
    ``rayleigh_ritz.gram_f64_p``).  ``chunk=0`` picks
    ``divisor_chunk(D, GRAM_CHUNK)``; the double sum is all-reduced over
    ``reduce_axis``.  Kernel K6 on the card (``_gram``)."""
    return _gram(x, y, chunk, reduce_axis, False)


def gram(x, y, reduce_axis=None) -> torch.Tensor:
    """The Gram conj(X) Y^T (p, q) in the working precision, for
    projections (twin of ``rayleigh_ritz.gram_p32``): ``gram_f64``
    rounded, as one GEMM over all of D loses digits on the card."""
    return _gram(x, y, 0, reduce_axis, True)


def combine(blocks: Sequence[torch.Tensor], coeffs: Sequence[torch.Tensor],
            addend: Optional[torch.Tensor] = None,
            subtract: bool = False) -> torch.Tensor:
    """out_j = addend_j + sum_b sum_i coeffs[b][i, j] blocks[b]_i (with
    ``subtract``, addend_j minus the sum) for blocks (..., p_b, D),
    coefficients (..., p_b, q) and an addend (..., q, D): the rows of all
    blocks summed in order, the addend last.  Routed by dtype and size
    alone: on the card a complex64 call within kernel K4's row and output
    limits is one launch of K4, which reads the blocks where they lie, or
    raises where K4 cannot read an operand (counter ``dense.k4``); a
    complex64 call past those limits is K4's plain version, one
    ``torch.matmul`` over the stacked blocks (``dense.matmul``), as is a
    call in another dtype (complex128: the refine, ``f64_truth``) and every
    CPU call."""
    b0 = blocks[0]
    if b0.is_cuda and b0.dtype == torch.complex64:
        if (coeffs[0].shape[-1] <= MAX_Q
                and sum(b.shape[-2] for b in blocks) <= MAX_ROWS):
            out = block_combine(blocks, coeffs, addend, subtract)
            tracing.count("dense.k4")
            return out
        tracing.count("dense.matmul")
    return block_combine_plain(blocks, coeffs, addend, subtract)


def mix(c: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """out_j = sum_i c[i, j] blocks_i; c (..., p, q), blocks (..., p, D) ->
    (..., q, D) (twin of ``rayleigh_ritz.mix_pair``), by ``combine``."""
    return combine((blocks,), (c,))


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


def eigh(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh``, the solvers' only call of it (span
    ``pcx.eigh``, counter ``sync.eigh``): on the card it reads its error
    flag back to the host, which synchronizes."""
    tracing.count("sync.eigh")
    with tracing.span("pcx.eigh"):
        return torch.linalg.eigh(t)


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
    return eigh(t + torch.diag_embed(pert).to(C128))


def _absmax(a: torch.Tensor) -> torch.Tensor:
    """max |a| over the last two axes (the whole matrix, each lane's)."""
    return a.abs().amax(dim=(-2, -1))


def _projection(against: Sequence[torch.Tensor], block: torch.Tensor,
                reduce_axis=None) -> Sequence[torch.Tensor]:
    """The coefficients of ``block`` on each base of ``against`` (the
    Grams base^H block).  A complex64 block on the card takes one Gram of
    the stacked bases (kernel K6 reads each base where it lies and the
    block once), its rows split by base; elsewhere each base takes its own
    Gram, as a BLAS may round a row of a stacked product otherwise
    (complex128 blocks of 5 rows on the CPU)."""
    if block.is_cuda and block.dtype == torch.complex64:
        return torch.split(gram(against, block, reduce_axis),
                           [b.shape[-2] for b in against], dim=-2)
    return [gram(base, block, reduce_axis) for base in against]


@tracing.spanned("pcx.svqb")
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
    for pno in range(passes):
        if against:
            coeffs = _projection(against, block, reduce_axis)
            block = combine(against, coeffs, block, subtract=True)
            if hb is not None and h_against:
                hb = combine(h_against, coeffs, hb, subtract=True)
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
    lam, u = eigh(g)
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
    theta, v = eigh(tw + torch.diag(pert + bump).to(C128))
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
    theta, q = eigh(hermitize(t2))
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
            block = combine((base,), (coeff,), block, subtract=True)
            if hblock is not None and hbase is not None:
                hblock = combine((hbase,), (coeff,), hblock, subtract=True)
    q = block.clone()
    hq = hblock.clone() if hblock is not None else None
    idx = torch.arange(m, device=block.device)
    for i in range(m):
        col = q[..., i:i + 1, :]
        hcol = hq[..., i:i + 1, :] if hq is not None else None
        wsel = ((idx < i).to(rdtype) * msk)[..., None]
        for _ in range(passes):
            coeff = gram(q, col, reduce_axis) * wsel
            col = combine((q,), (coeff,), col, subtract=True)
            if hq is not None:
                hcol = combine((hq,), (coeff,), hcol, subtract=True)
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
    block = combine((basis,), (coeff,), block, subtract=True)
    if hblock is not None:
        hblock = combine((hbasis,), (coeff,), hblock, subtract=True)
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
