"""3x3 block-diagonal multiplies on (..., 3, N, N, N) complex fields.

Port of ``pcx/operators/blocks.py`` (and of the pair versions
``rs.a_block_p`` / ``rs.h_block_p``).  A symbol d is (3, N, N, N) and
broadcasts against a block x of shape (m, 3, N, N, N); the component axis
is the fourth from the end of both, so that the lanes of the k-point batch,
symbols (L, 1, 3, N, N, N) against blocks (L, c, 3, N, N, N), broadcast
the same way.
"""

from __future__ import annotations

import torch

from pcx_torch.operators.symbols import HermSymbol


def _comps(a: torch.Tensor) -> tuple:
    """The three components of a field or symbol (axis -4)."""
    return a[..., 0, :, :, :], a[..., 1, :, :, :], a[..., 2, :, :, :]


def a_block(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Antisymmetric curl-block multiply:
    y = [[0,-d3,d2],[d3,0,-d1],[-d2,d1,0]] x
    (reference: a_block_kernel, paper_2/_kernels.py:43-71)."""
    x0, x1, x2 = _comps(x)
    d0, d1, d2 = _comps(d)
    return torch.stack((d1 * x2 - d2 * x1,
                        d2 * x0 - d0 * x2,
                        d0 * x1 - d1 * x0), dim=-4)


def h_block(x: torch.Tensor, sym: HermSymbol) -> torch.Tensor:
    """Hermitian 3x3 block multiply
    y = [[d11, s12, s13], [s12*, d22, s23], [s13*, s23*, d33]] x
    (reference: h_block_kernel, paper_2/_kernels.py:13-41)."""
    d, s = sym
    d0, d1, d2 = _comps(d)
    s0, s1, s2 = _comps(s)
    x0, x1, x2 = _comps(x)
    return torch.stack((d0 * x0 + s0 * x1 + s1 * x2,
                        s0.conj() * x0 + d1 * x1 + s2 * x2,
                        s1.conj() * x0 + s2.conj() * x1 + d2 * x2),
                       dim=-4)


def h_block_planes(xr: torch.Tensor, xi: torch.Tensor, diag: torch.Tensor,
                   sr: torch.Tensor, si: torch.Tensor):
    """``h_block`` on real and imaginary planes, for a real dtype with no
    complex counterpart (bfloat16: the preconditioner of
    ``solver="mixed"``); the operations of ``rs.h_block_p`` in its order.
    Returns (yr, yi)."""
    def comp(a, c):
        return a[..., c, :, :, :]

    def mul(a, b):             # complex product of two (re, im) pairs
        return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]

    def add(*terms):
        re, im = terms[0]
        for t in terms[1:]:
            re, im = re + t[0], im + t[1]
        return re, im

    x0, x1, x2 = ((comp(xr, c), comp(xi, c)) for c in range(3))
    s0, s1, s2 = ((comp(sr, c), comp(si, c)) for c in range(3))
    c0, c1, c2 = ((comp(sr, c), -comp(si, c)) for c in range(3))
    dg = [comp(diag, c) for c in range(3)]
    y0 = add((x0[0] * dg[0], x0[1] * dg[0]), mul(s0, x1), mul(s1, x2))
    y1 = add(mul(c0, x0), (x1[0] * dg[1], x1[1] * dg[1]), mul(s2, x2))
    y2 = add(mul(c1, x0), mul(c2, x1), (x2[0] * dg[2], x2[1] * dg[2]))
    return (torch.stack((y0[0], y1[0], y2[0]), dim=-4),
            torch.stack((y0[1], y1[1], y2[1]), dim=-4))


def diag_block(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain diagonal multiply y_c = d_c * x_c."""
    return d * x
