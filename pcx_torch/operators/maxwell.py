"""Matrix-free penalized Maxwell operator in Fourier space.

Port of ``pcx/operators/maxwell.py`` with ``rs.ama_p`` / ``rs.ama_bb_p``:

    ama(x)    = Ablk(D_A) . ifftn . M . fftn . Ablk(-conj(D_A)) x
    ama_bb(x) = ama(x) + Hblk(pnt * B) x + shift * x

The LOBPCG block lives in Fourier space, so one apply costs one forward and
one inverse 3-D DFT around the physical-space dielectric; the penalty and
the preconditioner are zero-FFT block multiplies
(reference: AMA / AMA_BB, paper_2/pcfft.py:130-181).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pcx_torch.operators.blocks import a_block, h_block
from pcx_torch.operators.dft import DFTMats, dft3
from pcx_torch.operators.symbols import HermSymbol
from pcx_torch.utils import real_dtype

_SPATIAL = (-3, -2, -1)


def ama(x: torch.Tensor, d_a: torch.Tensor, diel,
        dft: Optional[DFTMats] = None) -> torch.Tensor:
    """A M A^H on a Fourier-space block (..., 3, N, N, N), M = ``diel``
    being any ``dielectric.DielectricOp`` (a real scale, a Hermitian block
    or the cross-DoF stencil).  With ``dft`` the transforms are the matmul
    DFT (kernel K2 for complex64); without it, torch.fft (the complex128
    refine)."""
    y = a_block(x, -d_a.conj())
    if dft is None:
        y = torch.fft.fftn(y, dim=_SPATIAL)
        y = torch.fft.ifftn(diel(y), dim=_SPATIAL)
    else:
        y = dft3(diel(dft3(y, dft.fwd)), dft.inv)
    return a_block(y, d_a)


def ama_bb(x: torch.Tensor, d_a: torch.Tensor, b: HermSymbol, diel,
           shift: float = 0.0, dft: Optional[DFTMats] = None) -> torch.Tensor:
    """A M A^H + pnt B^H B (+ shift); ``b`` already includes pnt."""
    y = ama(x, d_a, diel, dft) + h_block(x, b)
    if shift != 0.0:
        y = y + shift * x
    return y


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
