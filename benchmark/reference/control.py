"""The control of the comparison: the reference put in the program's place
at the nearest precision below the configuration's.

The configuration iterates in complex64 with TF32 off, so the control
computes the reference's answer from the program's block in complex64
with TF32 products in its Grams (each operand's mantissa rounded to TF32's
10 bits, products added in float32, as a TF32 GEMM does): the operator in
complex64, the Rayleigh-Ritz pencil and the Rayleigh quotients from TF32
Grams.  Its answer (frequencies and Ritz block) goes to ``judge`` as the
program's would; ``correct`` has to come out false on it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import maxwell


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (complex64 or float32) with every float's mantissa rounded to
    the nearest of TF32's 10 bits."""
    r = torch.view_as_real(t) if t.is_complex() else t
    bits = r.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.view_as_complex(out) if t.is_complex() else out


def _gram(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    return (tf32(a).conj() @ tf32(b).transpose(0, 1)).cpu().numpy()


def answer(config: dict, op: maxwell.Operator, x: torch.Tensor):
    """(omega, omega_re, block) that the control reports at one k-point
    from the program's Ritz block ``x``."""
    nev = config["nev"]
    op32 = maxwell.Operator.__new__(maxwell.Operator)
    op32.shift, op32.pnt = op.shift, op.pnt
    op32.d = op.d.to(torch.complex64)
    op32.diel = op.diel.to(torch.float32)
    m = x.shape[0]
    x = x.to(torch.complex64)
    xf = x.reshape(m, -1)
    t = _gram(xf, op32.h(x).reshape(m, -1))
    g = _gram(xf, xf)
    t, g = (t + t.conj().T) / 2, (g + g.conj().T) / 2
    inv = np.linalg.inv(np.linalg.cholesky(g))
    theta, v = np.linalg.eigh(inv @ t @ inv.conj().T)
    c = torch.as_tensor((inv.conj().T @ v).T.copy(), device=x.device,
                        dtype=torch.complex64)
    block = (c @ xf).reshape(x.shape)
    y = block[:nev]
    yf = y.reshape(nev, -1)
    ay = op32.a(y).reshape(nev, -1)
    num = np.diagonal(_gram(yf, ay)).real
    den = np.diagonal(_gram(yf, yf)).real
    lam_pnt = theta[:nev] - (op.shift if op.shift > 0 else 0.0)
    return maxwell.frequency(lam_pnt), maxwell.frequency(num / den), block
