"""Inverse-dielectric operator M = eps^{-1}, applied in physical space.

Port of the chiral (isotropic two-material) case of
``pcx/operators/dielectric.py`` (``DielectricOp``, ``chiral_op``): y = x at
vacuum edge DoFs and x / eps at material ones, applied as one multiply by a
(3, N, N, N) scale
(reference: chiral_handle, paper_2/discretization.py:352-366).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pcx_torch import geometry
from pcx_torch.config import CHIRAL_EPS_EG


class DielectricOp(nn.Module):
    """x -> x * scale with a real (3, N, N, N) ε⁻¹ scale.

    The scale is held in float64 (the complex128 refine multiplies by it)
    and once more in float32 for the complex64 iterate, so no apply casts."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale64", scale.to(torch.float64))
        self.register_buffer("scale32", scale.to(torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale32 if x.dtype == torch.complex64 else self.scale64
        return x * s


def chiral_op(n: int, lattice: Optional[str], device, eps: float = 0.0,
              edge_mask: Optional[np.ndarray] = None) -> DielectricOp:
    """Divide by eps inside the material region (eps defaults to the
    lattice's constant, config.CHIRAL_EPS_EG)."""
    if not eps:
        eps = CHIRAL_EPS_EG[lattice]
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    scale = np.where(edge_mask, 1.0 / eps, 1.0)
    return DielectricOp(torch.as_tensor(scale, device=device))
