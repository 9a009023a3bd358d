"""3-D DFT as three explicit axis contractions with f32-accurate products.

Port of ``pcx/operators/dft.py``.  The TPU's builtin FFT lowers to
reduced-precision passes that raise the LOBPCG residual floor ~100x and breed
phantom Ritz values; pcx therefore applies the DFT along each grid axis as an
(N, N) matrix contraction at full precision.  The port keeps that form for
the complex64 iterate: each pass is kernel K2 (``pcx_torch.kernels.axis_dft``,
3xTF32 products on the card's tensor cores, the counterpart of the TPU's
Precision.HIGHEST), which contracts the -3rd axis and writes the transformed
axis last, so three passes restore the axis order.  complex128 (the CPU parity runs) takes the
plain einsum; the complex128 refine uses ``torch.fft`` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcx_torch.kernels.axis_dft import axis_dft, axis_dft_plain


class DFTMats(NamedTuple):
    """Forward/inverse DFT matrices, each (N, N) complex:
    fwd[j, k] = exp(-2 pi i j k / N); inv = conj(fwd) / N, the normalization
    of torch.fft.fftn / ifftn."""
    fwd: torch.Tensor
    inv: torch.Tensor


def dft_mats(n: int, dtype: torch.dtype, device) -> DFTMats:
    """Twiddles built in complex128 and cast to ``dtype`` on ``device``."""
    j = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(j, j) / n)
    return DFTMats(*(torch.as_tensor(a, device=device).to(dtype)
                     for a in (w, w.conj() / n)))


def dft3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3-D DFT over the last three axes of x by three axis passes with the
    (N, N) matrix w.  complex64 goes through K2 (the kernel on CUDA, its
    plain version on the CPU); complex128 through the plain einsum."""
    lead, n3 = x.shape[:-3], x.shape[-3:]
    axis_pass = axis_dft if x.dtype == torch.complex64 else axis_dft_plain
    cur = x.reshape((-1,) + n3)
    for _ in range(3):
        cur = axis_pass(cur, w)
    return cur.reshape(lead + n3)
