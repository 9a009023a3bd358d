"""Fourier symbols of the discrete curl / divergence-penalty operators,
built on the device from 1-D stencil parts.

Port of ``pcx/operators/symbols.py`` and of the on-device constructors
``rs.build_curl_p``, ``rs.penalty_p`` and ``rs.inverse_penalized_p``.  The
uniform periodic grid makes every stencil matrix block-circulant, hence
diagonal in the 3-D DFT basis; the (3, N, N, N) symbols are closed-form
broadcasts of (N,)-sized parts, so only those parts live on the host.

Symbols are built in complex128 / float64 and cast to the iterate dtype by
the caller (``HermSymbol.to``), as the JAX solver does
(``bandstructure.py:533-546``).

* curl symbol   ``D_A[c] = sum_j CT[c,j] * d1[axis j] + i*alpha_c*d0[axis c]``
  (reference: discretization.py:301-346),
* penalty       ``B = pnt * (|D_A[c]|^2, conj(D_A[a]) D_A[b])``
  (reference: discretization.py:343-344),
* preconditioner ``(A A^H + pnt B^H B + shift)^{-1}`` by the closed-form
  Hermitian 3x3 block inverse (reference: discretization.py:224-295).

Two families live here.  The main path builds from the 1-D parts:
``symbol_parts``, ``build_curl``, ``penalty(d_a, pnt)`` (already scaled by
pnt) and ``inverse_penalized(d_a, pnt, shift)``.  The full-array functions
of ``pcx/operators/symbols.py`` take and return (3, N, N, N) tensors, for
``maxwell.assemble_symbols`` and the experiments: ``curl_symbols``,
``shift_symbol``, ``penalty_symbol`` (unscaled), ``inverse_3x3_block``,
``inverse_gram`` and ``inverse_penalized_b``, which is the JAX package's
``inverse_penalized(b, pnt, shift)`` taking the penalty symbol ``b``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcx_torch import stencils, tracing
from pcx_torch.config import SCAL
from pcx_torch.utils import real_dtype


class HermSymbol(NamedTuple):
    """Hermitian 3x3 block symbol: real diag (3,N,N,N) = (d11, d22, d33)
    and complex sdiag (3,N,N,N) = (s12, s13, s23)."""
    diag: torch.Tensor
    sdiag: torch.Tensor

    def to(self, dtype: torch.dtype) -> "HermSymbol":
        """Cast to a complex iterate dtype (diag to its real dtype)."""
        return HermSymbol(self.diag.to(real_dtype(dtype)),
                          self.sdiag.to(dtype))


class SymbolParts(NamedTuple):
    """k-independent (N,)-sized parts the symbols are built from:
    d1/d0 complex128 (already divided by the lattice constant), ct (3, 3)
    float64."""
    d1: torch.Tensor
    d0: torch.Tensor
    ct: torch.Tensor


def symbol_parts(n: int, k: int, ct: np.ndarray, scal: float,
                 device) -> SymbolParts:
    """The 1-D stencil symbols of ``KPointSolver._f64`` (pcx
    bandstructure.py:378-389), on ``device``."""
    d1 = stencils.symbol_1d(n, k, 1, 1.0 / n) / scal
    d0 = stencils.symbol_1d(n, k, 0) / scal
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                         device=device)
    return SymbolParts(as_t(d1, torch.complex128), as_t(d0, torch.complex128),
                       as_t(ct, torch.float64))


def _bcast(v: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def build_curl(parts: SymbolParts, alpha) -> torch.Tensor:
    """Curl symbol D_A, complex128 (3, N, N, N), from the 1-D parts
    (twin of ``rs.build_curl_p``).  Uploads alpha: on the card a host
    sync (counter ``sync.upload``)."""
    d1, d0, ct = parts
    n = d1.shape[0]
    tracing.count("sync.upload")
    alpha = torch.as_tensor(np.asarray(alpha, np.float64), device=d1.device)
    rows = []
    for c in range(3):
        acc = sum(ct[c, j] * _bcast(d1, j) for j in range(3))
        acc = acc + 1j * alpha[c] * _bcast(d0, c)
        rows.append(acc.expand(n, n, n))
    return torch.stack(rows)


def _pairs(d_a: torch.Tensor):
    """(s12, s13, s23) = conj(D_a) D_b for (a, b) in (0,1), (0,2), (1,2)."""
    return [d_a[a].conj() * d_a[b] for a, b in ((0, 1), (0, 2), (1, 2))]


def penalty(d_a: torch.Tensor, pnt: float) -> HermSymbol:
    """pnt-scaled penalty symbol B^H B from the curl symbol
    (twin of ``rs.penalty_p``)."""
    diag = (d_a.conj() * d_a).real * pnt
    return HermSymbol(diag, torch.stack(_pairs(d_a)) * pnt)


def inverse_penalized(d_a: torch.Tensor, pnt: float,
                      shift: float = 0.0) -> HermSymbol:
    """Preconditioner symbol (A A^H + pnt B^H B + shift)^{-1}
    (twin of ``rs.inverse_penalized_p``): Hermitian 3x3 adjugate over the
    real determinant."""
    b0, b1, b2 = (d_a.conj() * d_a).real
    d0 = pnt * b0 + b1 + b2 + shift
    d1 = b0 + pnt * b1 + b2 + shift
    d2 = b0 + b1 + pnt * b2 + shift
    s0, s1, s2 = (s * (pnt - 1.0) for s in _pairs(d_a))
    a0, a1, a2 = ((s.conj() * s).real for s in (s0, s1, s2))
    tri = 2.0 * (s0 * s2 * s1.conj()).real
    det = d0 * d1 * d2 - (d0 * a2 + d1 * a1 + d2 * a0) + tri
    inv_det = 1.0 / det
    f_diag = torch.stack(((d1 * d2 - a2) * inv_det,
                          (d0 * d2 - a1) * inv_det,
                          (d0 * d1 - a0) * inv_det))
    f_sdiag = torch.stack(((s1 * s2.conj() - s0 * d2) * inv_det,
                           (s0 * s2 - s1 * d1) * inv_det,
                           (s1 * s0.conj() - s2 * d0) * inv_det))
    return HermSymbol(f_diag, f_sdiag)


# ---------------------------------------------------------------------------
# Full-array symbols (pcx/operators/symbols.py:49-152).
# ---------------------------------------------------------------------------

def curl_symbols(n: int, k: int, ct: np.ndarray, scal: float = SCAL,
                 device="cuda", dtype: torch.dtype = torch.complex128):
    """k-independent symbol parts (D, Di), each (3, N, N, N):
    D[c] = sum_j CT[c,j] * D1[axis j] (the curl part, D1 with grid step
    scal / N) and Di[c] = D0[axis c] (to be scaled by i*alpha_c)
    (reference: paper_2/discretization.py:301-335, alpha=None branch)."""
    d1 = torch.as_tensor(np.asarray(stencils.symbol_1d(n, k, 1, scal / n)),
                         device=device).to(dtype)
    d0 = torch.as_tensor(np.asarray(stencils.symbol_1d(n, k, 0)),
                         device=device).to(dtype)
    ct = np.asarray(ct, dtype=np.float64)
    d = torch.stack([sum(float(ct[c][j]) * _bcast(d1, j) for j in range(3))
                     .expand(n, n, n) for c in range(3)])
    di = torch.stack([_bcast(d0, c).expand(n, n, n) for c in range(3)])
    return d, di


def shift_symbol(d: torch.Tensor, di: torch.Tensor, alpha,
                 scal: float = SCAL) -> torch.Tensor:
    """Apply the k-point shift: D_A[c] = D[c] + i*(alpha_c/scal)*Di[c]
    (reference: discretization.py:337-341, numerical_experiments.py:
    434-436)."""
    alpha = torch.as_tensor(np.asarray(alpha, dtype=np.float64) / scal,
                            device=d.device)
    return d + 1j * alpha[:, None, None, None] * di


def penalty_symbol(d_a: torch.Tensor) -> HermSymbol:
    """The unscaled B^H B block symbol of the curl symbol: diag |D_c|^2,
    sdiag conj(D_a) D_b (reference: discretization.py:343-344)."""
    return HermSymbol((d_a.conj() * d_a).real, torch.stack(_pairs(d_a)))


def inverse_3x3_block(diag: torch.Tensor, sdiag: torch.Tensor,
                      shift: float = 0.0,
                      hermitian: bool = True) -> HermSymbol:
    """Closed-form inverse of a Hermitian 3x3 block symbol, adjugate over
    determinant (reference: paper_2/discretization.py:224-270)."""
    d0, d1, d2 = diag[0] + shift, diag[1] + shift, diag[2] + shift
    s0, s1, s2 = sdiag[0], sdiag[1], sdiag[2]
    det = (d0 * d1 * d2
           - (d0 * (s2 * s2.conj()) + d1 * (s1 * s1.conj())
              + d2 * (s0 * s0.conj()))
           + 2 * (s0 * s2 * s1.conj()).real)
    f_diag = torch.stack(((d1 * d2 - s2 * s2.conj()) / det,
                          (d0 * d2 - s1 * s1.conj()) / det,
                          (d0 * d1 - s0 * s0.conj()) / det))
    if hermitian:
        f_diag = f_diag.real
    f_sdiag = torch.stack(((s1 * s2.conj() - s0 * d2) / det,
                           (s0 * s2 - s1 * d1) / det,
                           (s1 * s0.conj() - d0 * s2) / det))
    return HermSymbol(f_diag, f_sdiag)


def inverse_penalized_b(b: HermSymbol, pnt: float,
                        shift: float = 0.0) -> HermSymbol:
    """Symbol of (A A^H + pnt B^H B + shift)^{-1} from the unscaled penalty
    symbol ``b`` (the JAX package's ``inverse_penalized(b, pnt, shift)``):
    diagonal pnt*|D_c|^2 + sum_{c' != c} |D_c'|^2, off-diagonal
    (pnt - 1) * sdiag (reference: paper_2/discretization.py:284-295)."""
    b0, b1, b2 = b.diag[0], b.diag[1], b.diag[2]
    diag = torch.stack((pnt * b0 + b1 + b2, b0 + pnt * b1 + b2,
                        b0 + b1 + pnt * b2))
    return inverse_3x3_block(diag, (pnt - 1.0) * b.sdiag, shift=shift)


def inverse_gram(d_a: torch.Tensor, shift: float = 1.0) -> HermSymbol:
    """Symbol of (A A^H + shift)^{-1}, the curl-only preconditioner
    (reference: discretization.py:272-282)."""
    ds = (d_a.conj() * d_a).real
    diag = torch.stack((ds[1] + ds[2], ds[0] + ds[2], ds[0] + ds[1]))
    sdiag = -torch.stack(_pairs(d_a))
    return inverse_3x3_block(diag, sdiag, shift=shift)
