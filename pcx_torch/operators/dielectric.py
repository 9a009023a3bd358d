"""Inverse-dielectric operators M = eps^{-1}, applied in physical space.

Port of ``pcx/operators/dielectric.py``.  The reference builds these as
index scatters (chiral, paper_2/discretization.py:352-366) or CSR matrices
assembled with sparse Kronecker products (pseudochiral,
paper_2/discretization.py:368-453); here all are mask-based elementwise or
stencil operations on tensors, with no sparse storage:

* chiral:                y = x * scale, scale = 1/eps at material edge
                         DoFs and 1 elsewhere;
* pseudochiral trivial:  a pointwise Hermitian 3x3 block with a spatially
                         varying real diagonal (edge masks) and complex
                         off-diagonal (volume mask): one ``h_block``;
* pseudochiral crossdof: the same diagonal, the off-diagonal coupling
                         through separable 2k-wide averaging stencils
                         restricted by the per-component edge masks
                         (``torch.roll``), in place of sparse_kron + SpMV;
                         a complex64 apply on the card is one launch of
                         kernel K7 (``kernels/crossdof.py``), the same bits.

Every operator is an ``nn.Module`` whose arrays are buffers on an explicit
device, held twice: in float64 / complex128 for the complex128 refine and
in float32 / complex64 for the complex64 iterate, so that no apply casts.
The float64 copy holds the true double values (sqrt(1 + 0.875^2) / 13 is
not a float32 number), where the JAX package's complex64 solver stores
float32 and casts it up inside its f64 refine: the two refines see eps^{-1}
entries ~6e-8 relative apart, far below every gate.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from pcx_torch import geometry, stencils
from pcx_torch.config import (CHIRAL_EPS_EG, PSEUDOCHIRAL_EPS_LOC,
                              TYPE_CHIRAL, TYPE_PSEUDO_CROSSDOF,
                              TYPE_PSEUDO_TRIVIAL)
from pcx_torch.kernels import crossdof as k7
from pcx_torch.operators.blocks import h_block
from pcx_torch.operators.symbols import HermSymbol


class DielectricOp(nn.Module):
    """An inverse-dielectric operator on (..., 3, N, N, N) complex fields.

    ``diag`` / ``offdiag_abs_row_sums``: structural accessors (float64) of
    the operators that have them, used by the SDD / HPD censuses
    (reference: check_sdd, paper_2_test.py:259-297), matrix-free
    equivalents of the reference's CSR row scans.
    """

    name = "dielectric"

    def _hold(self, stem: str, array, device) -> None:
        """Register ``array`` (a tensor, or an array-like, which is copied)
        as the buffers ``<stem>64`` and ``<stem>32``."""
        if not isinstance(array, torch.Tensor):
            array = np.array(array)
        hi = torch.as_tensor(array, device=device)
        cplx = hi.is_complex()
        hi = hi.to(torch.complex128 if cplx else torch.float64)
        self.register_buffer(stem + "64", hi)
        self.register_buffer(stem + "32", hi.to(torch.complex64 if cplx
                                                else torch.float32))

    def _held(self, stem: str, x: torch.Tensor) -> torch.Tensor:
        """The copy of a held array in the precision of the field ``x``."""
        return getattr(self, stem + ("32" if x.dtype == torch.complex64
                                     else "64"))

    def diag(self) -> torch.Tensor:
        raise NotImplementedError(f"{self.name} has no SDD accessors")

    def offdiag_abs_row_sums(self) -> torch.Tensor:
        raise NotImplementedError(f"{self.name} has no SDD accessors")

    def sdd_violations(self) -> int:
        """Rows where strict diagonal dominance fails."""
        return int((self.diag() <= self.offdiag_abs_row_sums()).sum())


class IdentityOp(DielectricOp):
    """Vacuum (eps = 1)."""

    name = "identity"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ScaleOp(DielectricOp):
    """x -> x * scale with a real (N, N, N) or (3, N, N, N) eps^{-1} scale:
    the chiral dielectric and the scalar fields."""

    def __init__(self, scale, device=None, name: str = "scalar_field"):
        super().__init__()
        self.name = name
        self._hold("scale", scale, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self._held("scale", x)


class HermBlockOp(DielectricOp):
    """Pointwise Hermitian 3x3 block: a real (3, N, N, N) diagonal and a
    complex (3, N, N, N) off-diagonal (entries 12, 13, 23)."""

    name = TYPE_PSEUDO_TRIVIAL

    def __init__(self, diag, sdiag, device=None):
        super().__init__()
        self._hold("diag", diag, device)
        self._hold("sdiag", sdiag, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return h_block(x, HermSymbol(self._held("diag", x),
                                     self._held("sdiag", x)))

    def diag(self) -> torch.Tensor:
        return self.diag64

    def offdiag_abs_row_sums(self) -> torch.Tensor:
        a = self.sdiag64.abs()
        return torch.stack((a[0] + a[1], a[0] + a[2], a[1] + a[2]))


# ---------------------------------------------------------------------------
# Cross-DoF coupling via separable averaging stencils.
# ---------------------------------------------------------------------------

def _avg(x: torch.Tensor, sten, axis: int, transpose: bool,
         roll_fn=None) -> torch.Tensor:
    """1-D circulant averaging along ``axis``, into a new tensor.

    Forward form C:   (C x)[r]  = sum_{o=1-k..k} sten[o+k-1] * x[(r+o) % n]
    Transposed  C^T:  (C^T x)[r] = sum_{o}      sten[o+k-1] * x[(r-o) % n]
    Matches the circulant COO built at paper_2/discretization.py:428-431.
    ``roll_fn(x, shift, axis)`` defaults to torch.roll; a grid-sharded path
    substitutes a halo-exchange roll for the sharded axis.
    """
    if roll_fn is None:
        roll_fn = torch.roll
    k = len(sten) // 2
    out = None
    for j, w in enumerate(sten):
        o = j - (k - 1)           # offsets 1-k .. k
        shift = o if transpose else -o
        term = roll_fn(x, shift, axis) if shift else x
        out = w * term if out is None else out.add_(term, alpha=w)
    return out


# Axis indices within (..., 3, N, N, N): i -> -3, j -> -2, k -> -1, and the
# (pair) -> (row component, col component, T factors as (axis, transpose)).
_AX_I, _AX_J, _AX_K = -3, -2, -1
_PAIR_DEFS = {
    "12": (0, 1, ((_AX_K, False), (_AX_J, True))),
    "13": (0, 2, ((_AX_K, False), (_AX_I, True))),
    "23": (1, 2, ((_AX_J, False), (_AX_I, True))),
}


def _t_apply(x, sten, axes, transpose_all: bool, roll_fn=None):
    """T (or T^T) of one component pair: its 1-D averagings in turn."""
    for axis, tr in axes:
        x = _avg(x, sten, axis, tr != transpose_all, roll_fn)
    return x


def make_crossdof_apply(sten, eps3, eps4, eps5, roll_fn=None):
    """Cross-DoF eps^{-1} apply from (averaging stencil, off-diagonal eps
    entries); the spatial arrays come in as ``params = (diag, masks)``, both
    real (3, N, N, N) in the real dtype of the field.  Shared by the
    single-device operator and a grid-sharded path (which passes a
    halo-exchange ``roll_fn``).

    The eps entries are Python complex scalars, which leave a complex64
    field complex64.  A pair whose entry is zero is skipped, and each pair's
    two contributions are accumulated in place into the output, so one
    component-sized temporary chain is alive at a time.
    """
    pairs = tuple((*_PAIR_DEFS[key], complex(e))
                  for key, e in (("12", eps3), ("13", eps4), ("23", eps5)))

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        diag, masks = params
        y = x * diag
        xs, ys = x.unbind(-4), y.unbind(-4)
        for row, col, axes, e in pairs:
            if e == 0:
                continue
            # row block: e (R_row T + T R_col) / 2 applied to x_col
            t = _t_apply(xs[col], sten, axes, False, roll_fn)
            t.mul_(masks[row])
            t.add_(_t_apply(masks[col] * xs[col], sten, axes, False, roll_fn))
            ys[row].add_(t, alpha=0.5 * e)
            # its conjugate transpose: conj(e) (T^T R_row + R_col T^T) / 2
            # applied to x_row
            t = _t_apply(xs[row], sten, axes, True, roll_fn)
            t.mul_(masks[col])
            t.add_(_t_apply(masks[row] * xs[row], sten, axes, True, roll_fn))
            ys[col].add_(t, alpha=0.5 * e.conjugate())
        return y

    return apply


class CrossDofOp(DielectricOp):
    """Hermitian tensor eps^{-1} with the 2k-wide cross-DoF averaging
    coupling, from its real (3, N, N, N) diagonal, the (3, N, N, N) 0/1 edge
    masks, the averaging stencil and the three off-diagonal eps entries.

    A complex64 field on the card goes to kernel K7 (``crossdof_apply``),
    which launches or raises, and equals the eager composition bit for bit;
    complex128, the CPU and an operator built with a ``roll_fn`` take the
    eager composition."""

    name = TYPE_PSEUDO_CROSSDOF

    def __init__(self, diag, masks, sten, eps, device=None, roll_fn=None):
        super().__init__()
        self.sten = tuple(float(w) for w in sten)
        self.eps = tuple(complex(e) for e in eps)
        self._hold("diag", diag, device)
        self._hold("masks", masks, device)
        self._k7 = roll_fn is None
        self._apply_fn = make_crossdof_apply(self.sten, *self.eps,
                                             roll_fn=roll_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        diag, masks = self._held("diag", x), self._held("masks", x)
        if self._k7 and x.is_cuda and x.dtype == torch.complex64:
            return k7.crossdof_apply(x, diag, masks, self.sten, self.eps)
        return self._apply_fn((diag, masks), x)

    def diag(self) -> torch.Tensor:
        return self.diag64

    def offdiag_abs_row_sums(self) -> torch.Tensor:
        """|M_ab| entries factor exactly: entry = T_rc * (mask_row_r +
        mask_col_c) / 2 with T from real stencils, so the |M| row sums are
        the same separable stencils with |weights| (the reference scans the
        CSR, paper_2_test.py:259-269)."""
        masks = self.masks64
        sten_abs = tuple(abs(w) for w in self.sten)
        one = torch.ones_like(masks[0])
        sums = [torch.zeros_like(one) for _ in range(3)]
        for (row, col, axes), e in zip(_PAIR_DEFS.values(), self.eps):
            sums[row] += abs(e) * 0.5 * (
                masks[row] * _t_apply(one, sten_abs, axes, False)
                + _t_apply(masks[col], sten_abs, axes, False))
            sums[col] += abs(e) * 0.5 * (
                _t_apply(masks[row], sten_abs, axes, True)
                + masks[col] * _t_apply(one, sten_abs, axes, True))
        return torch.stack(sums)


# ---------------------------------------------------------------------------
# Constructors of each dielectric from (n, lattice, eps).
# ---------------------------------------------------------------------------

def identity_op() -> DielectricOp:
    """Vacuum (eps = 1), used by operator-only tests."""
    return IdentityOp()


def scalar_field_op(inv_eps, device) -> DielectricOp:
    """Spatially varying scalar eps^{-1} on a (N,N,N) or (3,N,N,N) grid
    (covers the smooth-eps ablation, paper_2/paper_2_test.py:146-190)."""
    return ScaleOp(np.asarray(inv_eps), device)


def smooth_eps_op(n: int, device,
                  eps_func: Optional[Callable] = None) -> DielectricOp:
    """Smooth spatially varying scalar eps evaluated at the staggered edge
    DoF coordinates (reference: largek_smooth_cmp, paper_2_test.py:146-190;
    default eps(x,y,z) = 8.9 sin(2 pi (x+y+z)) + 13)."""
    if eps_func is None:
        eps_func = lambda x, y, z: 8.9 * np.sin(2 * np.pi * (x + y + z)) + 13.0
    inv = np.empty((3, n, n, n))
    for c in range(3):
        x, y, z = geometry.edge_coords(n, c)
        inv[c] = 1.0 / np.broadcast_to(eps_func(x, y, z), (n, n, n))
    return scalar_field_op(inv, device)


def chiral_op(n: int, lattice: Optional[str], device, eps: float = 0.0,
              edge_mask: Optional[np.ndarray] = None) -> DielectricOp:
    """Isotropic two-material eps: divide by eps inside the material region
    (eps defaults to the lattice's constant, config.CHIRAL_EPS_EG).

    Reference: chiral_handle, paper_2/discretization.py:352-366.
    """
    if not eps:
        eps = CHIRAL_EPS_EG[lattice]
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    return ScaleOp(np.where(edge_mask, 1.0 / eps, 1.0), device,
                   name=TYPE_CHIRAL)


def _eps_components(lattice: str, eps_opt: int, eps_mat):
    """(d11,d22,d33,d12,d13,d23) of eps^{-1}, already divided by the chiral
    constant (reference: discretization.py:376-380, 411-414)."""
    if eps_mat is None:
        return PSEUDOCHIRAL_EPS_LOC[eps_opt] / CHIRAL_EPS_EG[lattice]
    return np.asarray(eps_mat)


def _masked_diag(edge_mask: np.ndarray, eps_loc) -> np.ndarray:
    """diag_c = eps_loc[c].real at material edge DoFs of component c, else
    1."""
    return np.stack([np.where(edge_mask[c], eps_loc[c].real, 1.0)
                     for c in range(3)])


def pseudochiral_trivial_op(n: int, lattice: Optional[str], device,
                            eps_opt: int = 0, eps_mat=None,
                            edge_mask: Optional[np.ndarray] = None,
                            vol_mask: Optional[np.ndarray] = None
                            ) -> DielectricOp:
    """Hermitian tensor eps^{-1} with trivial (collocated) cross-DoF
    coupling: the masked diagonal, and sdiag = eps_loc[3..5] at material
    volume cells, else 0.
    Reference: pseudochiral_trivial_handle, paper_2/discretization.py:368-401.
    """
    eps_loc = _eps_components(lattice, eps_opt, eps_mat)
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    if vol_mask is None:
        vol_mask = geometry.volume_mask(n, lattice)
    sdiag = np.stack([np.where(vol_mask, eps_loc[3 + c], 0.0)
                      for c in range(3)])
    return HermBlockOp(_masked_diag(edge_mask, eps_loc), sdiag, device)


def pseudochiral_crossdof_op(n: int, lattice: Optional[str], device,
                             eps_opt: int = 0, eps_mat=None, k: int = 1,
                             edge_mask: Optional[np.ndarray] = None,
                             roll_fn=None) -> DielectricOp:
    """Hermitian tensor eps^{-1} with 2k-wide cross-DoF averaging coupling,
    the HPD discretization of Paper 2.

    The reference assembles, for component pair (a, b), the CSR matrix
      M_ab = ( R_a T_ab + T_ab R_b ) / 2
    where R_c restricts to the material edge DoFs of component c and T_ab is
    a Kronecker product of 1-D averaging circulants
    (paper_2/discretization.py:403-453).  With the flat index i + j*N + k*N^2
    (i fastest) and the kron convention row = r_outer * n_inner + r_inner,
      T_12 = C  on axis k (slow)  o  C^T on axis j,
      T_13 = C  on axis k         o  C^T on axis i,
      T_23 = C  on axis j         o  C^T on axis i,
    applied here as separable roll stencils, with no sparse matrix.
    """
    eps_loc = _eps_components(lattice, eps_opt, eps_mat)
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    return CrossDofOp(_masked_diag(edge_mask, eps_loc),
                      np.asarray(edge_mask, dtype=np.float64),
                      stencils.mfd_stencil(k, 0), eps_loc[3:6], device,
                      roll_fn=roll_fn)


DIELECTRIC_REGISTRY: Dict[str, Callable] = {
    TYPE_CHIRAL: chiral_op,
    TYPE_PSEUDO_TRIVIAL: pseudochiral_trivial_op,
    TYPE_PSEUDO_CROSSDOF: pseudochiral_crossdof_op,
}


def build(diel_type: Optional[str], n: int, lattice: Optional[str], device,
          eps_opt: int = 0, eps_mat=None, k: int = 1) -> DielectricOp:
    """Registry dispatch (replaces the reference's string-eval dispatch,
    numerical_experiments.py:230, 349).  For ``chiral``, ``eps_opt`` is the
    eps value itself (0: the lattice's constant)."""
    if diel_type is None or diel_type == "identity":
        return identity_op()
    if diel_type == TYPE_CHIRAL:
        return chiral_op(n, lattice, device,
                         eps=float(eps_opt) if eps_opt else 0.0)
    if diel_type == TYPE_PSEUDO_TRIVIAL:
        return pseudochiral_trivial_op(n, lattice, device, eps_opt, eps_mat)
    if diel_type == TYPE_PSEUDO_CROSSDOF:
        return pseudochiral_crossdof_op(n, lattice, device, eps_opt, eps_mat,
                                        k=k)
    raise KeyError(f"Unknown dielectric type {diel_type!r}; "
                   f"known: {sorted(DIELECTRIC_REGISTRY)}")
