"""3x3 block-diagonal multiplies on (..., 3, N, N, N) complex fields.

Port of ``pcx/operators/blocks.py`` (and of the pair versions
``rs.a_block_p`` / ``rs.h_block_p``).  A symbol d is (3, N, N, N) and
broadcasts against a block x of shape (m, 3, N, N, N).
"""

from __future__ import annotations

import torch

from pcx_torch.operators.symbols import HermSymbol


def a_block(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Antisymmetric curl-block multiply:
    y = [[0,-d3,d2],[d3,0,-d1],[-d2,d1,0]] x
    (reference: a_block_kernel, paper_2/_kernels.py:43-71)."""
    x0, x1, x2 = x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]
    return torch.stack((d[1] * x2 - d[2] * x1,
                        d[2] * x0 - d[0] * x2,
                        d[0] * x1 - d[1] * x0), dim=-4)


def h_block(x: torch.Tensor, sym: HermSymbol) -> torch.Tensor:
    """Hermitian 3x3 block multiply
    y = [[d11, s12, s13], [s12*, d22, s23], [s13*, s23*, d33]] x
    (reference: h_block_kernel, paper_2/_kernels.py:13-41)."""
    d, s = sym
    x0, x1, x2 = x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]
    return torch.stack((d[0] * x0 + s[0] * x1 + s[1] * x2,
                        s[0].conj() * x0 + d[1] * x1 + s[2] * x2,
                        s[1].conj() * x0 + s[2].conj() * x1 + d[2] * x2),
                       dim=-4)
