"""Matrix-free penalized Maxwell operator in Fourier space.

Port of ``pcx/operators/maxwell.py`` with ``rs.ama_p`` / ``rs.ama_bb_p``:

    ama(x)    = Ablk(D_A) . ifftn . M . fftn . Ablk(-conj(D_A)) x
    ama_bb(x) = ama(x) + Hblk(pnt * B) x + shift * x

The LOBPCG block lives in Fourier space, so one apply costs one forward and
one inverse 3-D DFT around the physical-space dielectric; the penalty and
the preconditioner are zero-FFT block multiplies
(reference: AMA / AMA_BB, paper_2/pcfft.py:130-181).  On the card a
complex64 apply runs the block multiplies on either side of the DFTs as
kernel K5's two passes (``kernels/op_blocks.py``), the penalty and the
shift inside the second.

``MaxwellProblem`` (an ``nn.Module``), ``assemble_symbols`` and
``assemble_problem`` assemble one k-point from the full-array symbols, as
the JAX package's experiments and tests do; ``KPointSolver`` builds its
symbols from the 1-D parts instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from pcx_torch import lattices, tracing
from pcx_torch.config import SCAL, ProblemConfig, set_relaxation
from pcx_torch.kernels import op_blocks
from pcx_torch.operators import dielectric as diel_mod
from pcx_torch.operators import symbols as sym
from pcx_torch.operators.blocks import h_block
from pcx_torch.operators.dft import DFTMats, dft3
from pcx_torch.operators.symbols import HermSymbol
from pcx_torch.utils import real_dtype

_SPATIAL = (-3, -2, -1)


def ama(x: torch.Tensor, d_a: torch.Tensor, diel,
        dft: Optional[DFTMats] = None) -> torch.Tensor:
    """A M A^H on a Fourier-space block (..., 3, N, N, N), M = ``diel``
    being any ``dielectric.DielectricOp`` (a real scale, a Hermitian block
    or the cross-DoF stencil).  With ``dft`` the transforms are ``dft3``'s
    three axis passes (kernel K2 for complex64); without it, torch.fft (the
    complex128 refine).  One operator apply (span ``pcx.op``, counters
    ``op.applies`` and ``op.columns``)."""
    with tracing.span("pcx.op"):
        _count_apply(x)
        return _ama(x, d_a, diel, dft)


def _count_apply(x: torch.Tensor) -> None:
    tracing.count("op.applies")
    tracing.count("op.columns", math.prod(x.shape[:-4]))


def _ama(x: torch.Tensor, d_a: torch.Tensor, diel, dft: Optional[DFTMats],
         b: Optional[HermSymbol] = None, shift=0.0) -> torch.Tensor:
    """The apply of ``ama`` (``b`` None) or ``ama_bb``: the block multiplies
    on either side of the DFTs are K5's two passes (``op_pre``, ``op_post``)
    for a complex64 block on the card, which launch or raise on operands
    outside K5's layout; complex128 and the CPU take their eager
    composition (``op_pre_plain``, ``op_post_plain``), which K5 matches bit
    for bit."""
    k5 = x.is_cuda and x.dtype == torch.complex64
    y = (op_blocks.op_pre if k5 else op_blocks.op_pre_plain)(x, d_a)
    # the lanes of a k-point batch fold into the column axis around the
    # shared dielectric and DFT (one K2 pass over all lanes' columns)
    lead = y.shape[:-4]
    y = y.reshape((-1,) + y.shape[-4:])
    y = torch.fft.fftn(y, dim=_SPATIAL) if dft is None else dft3(y, dft)
    with tracing.span("pcx.diel"):
        y = diel(y)
    y = (torch.fft.ifftn(y, dim=_SPATIAL) if dft is None
         else dft3(y, dft, inverse=True))
    post = op_blocks.op_post if k5 else op_blocks.op_post_plain
    return post(y.reshape(lead + y.shape[-4:]), d_a, x, b, shift)


def ama_bb(x: torch.Tensor, d_a: torch.Tensor, b: HermSymbol, diel,
           shift=0.0, dft: Optional[DFTMats] = None) -> torch.Tensor:
    """A M A^H + pnt B^H B (+ shift); ``b`` already includes pnt.  Lanes of
    a k-point batch: x (L, c, 3, N, N, N) with symbols (L, 1, 3, N, N, N)
    and ``shift`` a real (L, 1, 1, 1, 1, 1) tensor.  One operator apply,
    as ``ama``."""
    with tracing.span("pcx.op"):
        _count_apply(x)
        return _ama(x, d_a, diel, dft, b, shift)


class MaxwellProblem(nn.Module):
    """Assembled single-k-point eigenproblem: the curl symbol ``d_a``, the
    pnt-scaled penalty symbol ``b`` and the preconditioner symbol ``inv``
    as buffers (``b`` and ``inv`` are ``HermSymbol`` views of the buffers
    ``b_diag``/``b_sdiag`` and ``inv_diag``/``inv_sdiag``), the dielectric
    as a submodule, and the scalars of the k-point
    (reference: uniform_initialization + pc_mfd_handle,
    paper_2/numerical_experiments.py:33-85; pcx maxwell.MaxwellProblem)."""

    def __init__(self, n: int, alpha, d_a: torch.Tensor, b: HermSymbol,
                 inv: HermSymbol, diel: diel_mod.DielectricOp, shift: float,
                 pnt: float, scal: float = SCAL):
        super().__init__()
        self.n = n
        self.alpha: Tuple[float, float, float] = tuple(
            float(a) for a in np.asarray(alpha, dtype=float))
        self.shift = float(shift)
        self.pnt = float(pnt)
        self.scal = float(scal)
        self.register_buffer("d_a", d_a)
        self.register_buffer("b_diag", b.diag)
        self.register_buffer("b_sdiag", b.sdiag)
        self.register_buffer("inv_diag", inv.diag)
        self.register_buffer("inv_sdiag", inv.sdiag)
        self.diel = diel

    @property
    def b(self) -> HermSymbol:
        return HermSymbol(self.b_diag, self.b_sdiag)

    @property
    def inv(self) -> HermSymbol:
        return HermSymbol(self.inv_diag, self.inv_sdiag)

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Unpenalized A M A^H, used by the validation recompute
        (reference: numerical_experiments.py:81)."""
        return ama(x, self.d_a, self.diel)

    def h_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Penalized operator with the shift (reference: num_exp.py:82)."""
        return ama_bb(x, self.d_a, self.b, self.diel, self.shift)

    def p_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Preconditioner (A A^H + pnt B^H B + shift)^{-1}: zero FFTs
        (reference: num_exp.py:83)."""
        return h_block(x, self.inv)

    @property
    def dof_shape(self):
        return (3, self.n, self.n, self.n)


def assemble_symbols(n: int, k: int, ct: np.ndarray, alpha, pnt: float,
                     shift: float, scal: float = SCAL,
                     dtype: torch.dtype = torch.complex128, device="cuda"):
    """(d_a, b, inv) of one dimensionless wave vector alpha, built in
    complex128 on ``device`` and cast to ``dtype`` (diagonals to its real
    dtype): D_A = (D_unit + i alpha D0) / scal, b = pnt * B^H B, and the
    shift already in physical units (reference chain at SCAL=1,
    num_exp.py:55-63; pcx maxwell.assemble_symbols)."""
    d, di = sym.curl_symbols(n, k, ct, scal=1.0, device=device)
    d_a = sym.shift_symbol(d, di, alpha, scal=1.0) / scal
    b_raw = sym.penalty_symbol(d_a)
    inv = sym.inverse_penalized_b(b_raw, pnt, shift=shift)
    b = HermSymbol(pnt * b_raw.diag, pnt * b_raw.sdiag)
    return d_a.to(dtype), b.to(dtype), inv.to(dtype)


def assemble_problem(cfg: ProblemConfig, alpha,
                     dtype: torch.dtype = torch.complex128,
                     diel: Optional[diel_mod.DielectricOp] = None,
                     device="cuda") -> MaxwellProblem:
    """The problem of one k-point on ``device``: set_relaxation, the
    symbols, and the dielectric of ``cfg`` unless ``diel`` is given
    (reference: numerical_experiments.py:33-85)."""
    (shift, _rlx), pnt = set_relaxation(alpha)
    shift = shift / cfg.scal ** 2
    ct = lattices.ct_matrix(cfg.lattice) if cfg.lattice else np.eye(3)
    d_a, b, inv = assemble_symbols(cfg.n, cfg.k, ct, alpha, pnt, shift,
                                   scal=cfg.scal, dtype=dtype, device=device)
    if diel is None:
        diel = diel_mod.build(cfg.diel_type, cfg.n, cfg.lattice, device,
                              eps_opt=cfg.eps_opt, k=cfg.k)
    return MaxwellProblem(cfg.n, alpha, d_a, b, inv, diel, shift, pnt,
                          cfg.scal)


def plane_wave_cols(d_a: np.ndarray, m: int):
    """Host-side column selection for the plane-wave start: returns
    (idx (m,) flat frequency indices, amps (m, 3) complex polarizations).

    At frequency f the vacuum operator A A^H acts on the 2-D transverse
    space { v : D(f) . v = 0 } as |D(f)|^2, so the best m-dimensional start
    for the lowest bands is the pair of polarizations at the m/2 smallest
    |D(f)|^2 (a copy of pcx maxwell.plane_wave_cols).
    """
    d = np.asarray(d_a).reshape(3, -1)
    score = np.sum(np.abs(d) ** 2, axis=0)
    n_freq = (m + 1) // 2 + 1
    sel = np.argpartition(score, n_freq)[:n_freq]
    sel = sel[np.argsort(score[sel])]

    idx, amps = [], []
    for f in sel:
        df = d[:, f]
        # Orthonormal basis of the transverse space {v : df . v = 0}
        # = orthogonal complement of conj(df).
        a = np.conj(df)
        na = np.linalg.norm(a)
        if na < 1e-14:
            basis = np.eye(3)[:, :2]
        else:
            a = a / na
            q, _ = np.linalg.qr(np.column_stack(
                [a, np.roll(np.eye(3), 1, 1)[:, :2]]))
            basis = q[:, 1:3]
        for p in range(2):
            if len(idx) >= m:
                break
            idx.append(int(f))
            amps.append(basis[:, p])
        if len(idx) >= m:
            break
    return np.asarray(idx, np.int64), np.stack(amps).astype(np.complex128)


def random_block(gen: torch.Generator, n: int, m: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """Random (m, 3, N, N, N) block, uniform [0, 1) real and imaginary
    parts (reference: numerical_experiments.py:66 uses rand + 1j*rand)."""
    shape = (m, 3, n, n, n)
    rdt = real_dtype(dtype)
    re = torch.rand(shape, generator=gen, dtype=rdt, device=device)
    im = torch.rand(shape, generator=gen, dtype=rdt, device=device)
    return torch.complex(re, im)


def plane_wave_scatter(idx: np.ndarray, amps: np.ndarray, n: int,
                       dtype: torch.dtype, device,
                       gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scatter the m one-hot polarization 3-vectors into a zero
    (m, 3, N^3) block on the device, plus 1e-2 times a random block from
    ``gen``: the exact eigenvectors are not plane waves, and a small random
    component breaks symmetry-induced invariant subspaces."""
    m = len(idx)
    x0 = torch.zeros((m, 3, n ** 3), dtype=dtype, device=device)
    x0[torch.arange(m, device=device), :,
       torch.as_tensor(idx, device=device)] = torch.as_tensor(
           amps, device=device).to(dtype)
    x0 = x0.reshape(m, 3, n, n, n)
    if gen is not None:
        x0 = x0 + 1e-2 * random_block(gen, n, m, dtype, device)
    return x0


def plane_wave_block(d_a, m: int, dtype: torch.dtype = torch.complex128,
                     device="cuda",
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Physics-informed (m, 3, N, N, N) start block: transverse plane waves
    at the m/2 lowest vacuum eigenvalues (``plane_wave_cols``), scattered on
    ``device``, plus 1e-2 times a random block from ``gen`` when one is
    given (pcx maxwell.plane_wave_block; its ``jitter_key``)."""
    d_a = (d_a.cpu().numpy() if isinstance(d_a, torch.Tensor)
           else np.asarray(d_a))
    idx, amps = plane_wave_cols(d_a, m)
    return plane_wave_scatter(idx, amps, d_a.shape[1], dtype, device, gen)
