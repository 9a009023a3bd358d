"""Dense local algebra of the production LOBPCG: Grams, mixes, masked SVQB
with column dropping, and the small Hermitian eigenproblems.

Port of the subset of ``pcx/solvers/rayleigh_ritz.py`` (and
``rs.pencil_f64_embedding``) that ``lobpcg_rs`` and the refine call.  Blocks
of vectors are (p, D) complex tensors, the vector index first.

The JAX package solves its small Hermitian problems through a real f64
embedding with emulated-f64 repairs, because the TPU has no complex128.  On
the card complex128 is native, so ``eigh_split`` is ``torch.linalg.eigh`` on
complex128 with the same graded degeneracy split (``split_for``), which
decides which directions SVQB drops.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pcx_torch.utils import norms, real_dtype

C128 = torch.complex128


def hermitize(a: torch.Tensor) -> torch.Tensor:
    """(A + A^H) / 2."""
    return 0.5 * (a + a.mH)


def divisor_chunk(d: int, target: int = 65536) -> int:
    """Largest Gram chunk <= target that divides d (so the chunked view needs
    no padding); ``target`` when d has no divisor near it."""
    lo = -(-d // target)
    for nc in range(lo, min(d, 4 * lo) + 1):
        if d % nc == 0:
            return d // nc
    return target


def gram_f64(x: torch.Tensor, y: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """G[i, j] = <x_i, y_j> (complex128) for row-blocks x (p, D), y (q, D),
    as working-precision partials over D-chunks summed in complex128: the
    error grows with sqrt(chunk), not sqrt(D)
    (twin of ``rayleigh_ritz.gram_f64_p``).  ``chunk=0`` picks
    ``divisor_chunk(D)``."""
    p, d = x.shape
    q = y.shape[0]
    chunk = chunk or divisor_chunk(d)
    nc = -(-d // chunk)
    pad = nc * chunk - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    xc = x.view(p, nc, chunk).transpose(0, 1)
    yc = y.view(q, nc, chunk).transpose(0, 1)
    # conj(G_c) = X_c Y_c^H: the conjugate rides on the transposed operand.
    part = torch.matmul(xc, yc.mH)
    return torch.conj_physical(part.to(C128).sum(dim=0))


def gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Working-precision Gram conj(X) Y^T (p, q), for projections
    (twin of ``rayleigh_ritz.gram_p32``)."""
    return torch.conj_physical(torch.matmul(x, y.mH))


def mix(c: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """out_j = sum_i c[i, j] blocks_i; c (p, q), blocks (p, D) -> (q, D)
    (twin of ``rayleigh_ritz.mix_pair``)."""
    return torch.matmul(c.transpose(0, 1), blocks)


colnorms = norms   # twin of ``rayleigh_ritz.colnorms_p``


def scale_cols(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return x * s.reshape((-1,) + (1,) * (x.dim() - 1)).to(real_dtype(x.dtype))


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
    p = t.shape[0]
    scale = t.real.abs().max() + t.imag.abs().max() + 1e-30
    pert = split * scale * torch.arange(p, dtype=torch.float64,
                                        device=t.device) / p
    return torch.linalg.eigh(t + torch.diag(pert).to(C128))


def masked_svqb_drop(block: torch.Tensor, mask: torch.Tensor,
                     drop_tol: float, hblock: Optional[torch.Tensor] = None,
                     against: Sequence[torch.Tensor] = (),
                     h_against: Sequence[torch.Tensor] = (),
                     passes: int = 2):
    """SVQB orthonormalization with dependent-direction DROPPING
    (twin of ``rayleigh_ritz.masked_svqb_drop_p``).

    Per pass: project off the orthonormal rows of ``against`` (working
    precision), form the complex128-accumulated Gram of the masked block;
    on the first pass eigendecompose it and drop directions with eigenvalue
    below max(drop_tol^2, lam_fac * split * gscale) (zeroed and masked out,
    never jitter-inflated), scaling the rest by 1/sqrt(eigenvalue); later
    passes are Gram Newton-Schulz steps (3 diag(mask) - G) / 2.
    ``hblock``/``h_against`` follow the same combinations.  Returns
    (q, hq, new_mask) with the mask in the real dtype."""
    cdtype = block.dtype
    rdtype = real_dtype(cdtype)
    mask = mask.to(torch.float64)
    split = split_for(rdtype, svqb=True)
    lam_fac = 10.0 if rdtype == torch.float32 else 1e3
    hb = hblock
    if len(against) > 1:
        against = (torch.cat(tuple(against)),)
        if h_against:
            h_against = (torch.cat(tuple(h_against)),)
    pairs = list(zip(against, h_against or [None] * len(against)))
    for pno in range(passes):
        for base, hbase in pairs:
            coeff = gram(base, block)
            block = block - mix(coeff, base)
            if hb is not None and hbase is not None:
                hb = hb - mix(coeff, hbase)
        keep = mask[:, None] * mask[None, :]
        g = hermitize(gram_f64(block, block)) * keep
        if pno == 0:
            gscale = g.real.abs().max() + g.imag.abs().max()
            lam_min = torch.clamp(lam_fac * split * gscale,
                                  min=float(drop_tol) ** 2)
            w, v = eigh_split(g, split)
            ok = (w > lam_min).to(torch.float64)
            coeff = (v * (ok / torch.sqrt(torch.maximum(w, lam_min)))
                     ).to(cdtype)
            mask = ok
        else:
            coeff = (1.5 * torch.diag(mask) - 0.5 * g).to(cdtype)
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
