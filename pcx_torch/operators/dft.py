"""3-D DFT as three axis passes at f32 accuracy.

Port of ``pcx/operators/dft.py``.  The TPU's builtin FFT lowers to
reduced-precision passes that raise the LOBPCG residual floor ~100x and breed
phantom Ritz values; pcx therefore applies the DFT along each grid axis as an
(N, N) matrix contraction at full precision.  The port keeps the three axis
passes for the complex64 iterate, each told its direction: each pass is
kernel K2 (``pcx_torch.kernels.axis_dft``, a mixed-radix FFT in IEEE f32 on
the card's CUDA cores), which transforms the -3rd axis and writes it last,
so three passes restore the axis order.  complex128 (the CPU parity runs)
takes the plain einsum with the matrices of ``DFTMats``; the complex128
refine uses ``torch.fft`` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcx_torch.kernels.axis_dft import (axis_dft, axis_dft_plain,
                                       dft_matrix_np)


class DFTMats(NamedTuple):
    """Forward/inverse DFT matrices, each (N, N) complex:
    fwd[j, k] = exp(-2 pi i j k / N); inv = conj(fwd) / N, the normalization
    of torch.fft.fftn / ifftn."""
    fwd: torch.Tensor
    inv: torch.Tensor


def dft_mats(n: int, dtype: torch.dtype, device) -> DFTMats:
    """Twiddles built in complex128 and cast to ``dtype`` on ``device``."""
    return DFTMats(*(torch.as_tensor(dft_matrix_np(n, inv),
                                     device=device).to(dtype)
                     for inv in (False, True)))


def dft3(x: torch.Tensor, mats: DFTMats, inverse: bool = False
         ) -> torch.Tensor:
    """3-D DFT over the last three axes of x by three axis passes, forward
    or inverse.  complex64 goes through K2 told the direction (the kernel on
    CUDA, its plain version on the CPU); complex128 through the plain einsum
    with ``mats.fwd`` or ``mats.inv``."""
    lead, n3 = x.shape[:-3], x.shape[-3:]
    cur = x.reshape((-1,) + n3)
    if x.dtype == torch.complex64:
        for _ in range(3):
            cur = axis_dft(cur, inverse)
    else:
        w = mats.inv if inverse else mats.fwd
        for _ in range(3):
            cur = axis_dft_plain(cur, w)
    return cur.reshape(lead + n3)


def upsample_mat(nc: int, n: int) -> np.ndarray:
    """(nc, n) complex128 trigonometric-interpolation matrix: contracting a
    periodic signal sampled on an nc-grid with it evaluates the signal's
    truncated Fourier series on the n-grid (zero-padded spectrum; the
    even-nc Nyquist bin split half and half onto +/- so that real inputs
    stay real).  It lifts a coarse-grid eigenvector block into a fine-grid
    start (``KPointSolver(x0_mode="coarse")``); a copy of
    ``pcx.operators.dft.upsample_mat``."""
    if n < nc:
        raise ValueError(f"upsample requires n >= nc, got {nc} -> {n}")
    fwd = np.exp(-2j * np.pi * np.outer(np.arange(nc), np.arange(nc)) / nc)
    # pad[k, k']: coarse frequency bin k -> fine frequency bin k'
    pad = np.zeros((nc, n), np.complex128)
    h = nc // 2
    for k in range(nc):
        if k < h or nc % 2 and k == h:
            pad[k, k] = 1.0
        elif k > h:
            pad[k, n - nc + k] = 1.0
        elif n == nc:
            pad[k, k] = 1.0
        else:   # even-nc Nyquist: split to keep conjugate symmetry
            pad[k, k] = 0.5
            pad[k, n - h] = 0.5
    g = np.exp(2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    return (fwd @ pad @ g.T) / nc


def resample3(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Apply the (n_in, n_out) matrix ``u`` along each of the last three
    axes of x: (..., nc, nc, nc) -> (..., n, n, n).  The same cyclic axis
    contraction as ``dft3`` (each pass writes its axis last, so three
    restore the order), by the plain einsum: ``u`` is not square, and the
    JAX package computes this outside any kernel."""
    lead = x.shape[:-3]
    cur = x.reshape((-1,) + x.shape[-3:])
    for _ in range(3):
        cur = axis_dft_plain(cur, u)
    return cur.reshape(lead + cur.shape[-3:])
