"""Mimetic finite-difference stencils and circulant Fourier symbols.

Host-side, exact-arithmetic construction.  The reference solves the stencil
system symbolically with SymPy to dodge Vandermonde ill-conditioning
(paper_2/discretization.py:152-193); here we solve it exactly over
``fractions.Fraction`` — no symbolic dependency, same exactness.

Circulant eigenvalues follow paper_2/discretization.py:195-222: the symbol of
a circulant stencil matrix is the (inverse-)DFT of its generating sequence.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from typing import List

import numpy as np


def _solve_exact(a: List[List[Fraction]], b: List[Fraction]) -> List[Fraction]:
    """Gaussian elimination with partial pivoting over Fractions."""
    n = len(b)
    m = [row[:] + [b[i]] for i, row in enumerate(a)]
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r][col] != 0)
        m[col], m[piv] = m[piv], m[col]
        inv = Fraction(1) / m[col][col]
        m[col] = [x * inv for x in m[col]]
        for r in range(n):
            if r != col and m[r][col] != 0:
                f = m[r][col]
                m[r] = [x - f * y for x, y in zip(m[r], m[col])]
    return [m[r][n] for r in range(n)]


@lru_cache(maxsize=None)
def _mfd_stencil_cached(k: int, deriv_order: int) -> tuple:
    num_points = 2 * k
    if deriv_order >= num_points:
        raise ValueError(
            f"Derivative order ({deriv_order}) must be less than the number "
            f"of stencil points ({num_points})."
        )
    # Stencil points at odd half-step offsets: p_j = 2(j - k) + 1, in units of
    # h/2 on the staggered (Yee) grid (reference: discretization.py:174).
    points = [Fraction(2 * (j - k) + 1) for j in range(num_points)]
    # Moment conditions: sum_j c_j p_j^i = (d+1) * delta_{i,d}.  The RHS d+1
    # accounts for the half-step units (reference: discretization.py:179-187).
    a = [[p**i for p in points] for i in range(num_points)]
    b = [Fraction(deriv_order + 1) if i == deriv_order else Fraction(0)
         for i in range(num_points)]
    sol = _solve_exact(a, b)
    return tuple(float(c) for c in sol)


def mfd_stencil(k: int, deriv_order: int) -> np.ndarray:
    """Symmetric 2k-point FD stencil for derivative order ``deriv_order``.

    k=1, d=1 -> [-1, 1] (staggered first difference);
    k=1, d=0 -> [1/2, 1/2] (staggered averaging).
    Reference: paper_2/discretization.py:152-193.
    """
    return np.array(_mfd_stencil_cached(k, deriv_order), dtype=np.float64)


def circulant_symbol(sten: np.ndarray, center: int, n: int) -> np.ndarray:
    """Eigenvalues of the N x N circulant matrix generated by ``sten``.

    The stencil entry ``sten[center-1]`` (1-based ``center``) sits on the main
    diagonal; entry ``sten[center-1+o]`` sits on superdiagonal ``o``.  With
    the DFT convention F[f,j] = exp(-2*pi*i*f*j/N), the eigenvalue at
    frequency f is  sum_o sten[center-1+o] * exp(+2*pi*i*f*o/N),
    i.e. N * ifft(c) where c[o mod N] = sten[center-1+o].
    Reference: paper_2/discretization.py:195-222.
    """
    sten = np.asarray(sten, dtype=np.float64)
    length = sten.shape[0]
    c = np.zeros(n, dtype=np.complex128)
    for j in range(length):
        o = j - (center - 1)       # superdiagonal offset of sten[j]
        c[o % n] += sten[j]
    return np.fft.ifft(c) * n


def symbol_1d(n: int, k: int, deriv_order: int, h: float = 1.0) -> np.ndarray:
    """Fourier symbol of the periodic staggered FD operator on n points.

    For deriv_order=1 the stencil is scaled by 1/h
    (reference: discretization.py:323).
    """
    sten = mfd_stencil(k, deriv_order)
    if deriv_order == 1:
        sten = sten / h
    return circulant_symbol(sten, k, n)
