"""K1 — fused residual, column sums of squares and preconditioner.

Replaces the Pallas TPU kernel ``fused_resid_precond``
(``pcx/operators/pallas_kernels.py:130, :200``), which the production
LOBPCG calls once per iteration through its ``rp_fused`` hook.  The CUDA
source is ``csrc/resid_precond.cu``; its header states what bounds the
kernel on the card and how the design answers it.

The wrapper also takes a lane axis, for the lanes of a k-point batch
(``KPointSolver.solve_batch``): L problems, x, hx (L, m, 3, D), lam (L, m)
and one symbol per lane (L, 3, D), in ONE launch of the same kernel; JAX
runs the TPU kernel's batch under ``jax.vmap``.  ``resid_precond.launches``
counts one per lane served.

It takes the plain PyTorch version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pcx_torch.kernels import _build
from pcx_torch.operators.blocks import h_block
from pcx_torch.operators.symbols import HermSymbol


def _check(x, hx, lam, inv_diag, inv_sd):
    if x.dim() not in (3, 4) or x.shape[-2] != 3:
        raise ValueError(f"x must be (m, 3, D) or (L, m, 3, D), got "
                         f"{tuple(x.shape)}")
    lead = x.shape[:-3]
    m, _, d = x.shape[-3:]
    want = {"x": (x, torch.complex64, lead + (m, 3, d)),
            "hx": (hx, torch.complex64, lead + (m, 3, d)),
            "lam": (lam, torch.float32, lead + (m,)),
            "inv_diag": (inv_diag, torch.float32, lead + (3, d)),
            "inv_sd": (inv_sd, torch.complex64, lead + (3, d))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def resid_precond_plain(x, hx, lam, inv_diag, inv_sd):
    """Plain PyTorch K1: r = lam x - hx, its column sums of squares, and
    w = P r with the Hermitian 3x3 symbol (unmasked), on either shape of
    ``resid_precond``."""
    lead = x.shape[:-3]
    m, _, d = x.shape[-3:]
    r = lam[..., None, None] * x - hx
    sumsq = torch.view_as_real(r).square().sum(dim=(-3, -2, -1))
    sym = HermSymbol(inv_diag.view(lead + (1, 3, 1, 1, d)),
                     inv_sd.view(lead + (1, 3, 1, 1, d)))
    w = h_block(r.view(lead + (m, 3, 1, 1, d)), sym).view(x.shape)
    return w, sumsq


def resid_precond(x: torch.Tensor, hx: torch.Tensor, lam: torch.Tensor,
                  inv_diag: torch.Tensor, inv_sd: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w, sumsq) for x, hx complex64 (m, 3, D), lam float32 (m,),
    inv_diag float32 (3, D), inv_sd complex64 (3, D) = (s12, s13, s23);
    or for L lanes, x, hx (L, m, 3, D), lam (L, m) and symbols (L, 3, D),
    lane l with its own symbol.

    w = P (lam x - hx), complex64 shaped like x, unmasked; sumsq float32
    (m,) or (L, m) is each column's ||lam x - hx||^2."""
    _check(x, hx, lam, inv_diag, inv_sd)
    if x.device.type == "cpu":
        return resid_precond_plain(x, hx, lam, inv_diag, inv_sd)
    if x.device.type != "cuda":
        raise ValueError(f"resid_precond runs on cpu or cuda, not {x.device}")
    args = (x, hx, lam, inv_diag, inv_sd)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("resid_precond: the kernel needs contiguous inputs")
    lanes = x.shape[0] if x.dim() == 4 else 1
    lib = _build.load()
    m, _, d = x.shape[-3:]
    w = torch.empty_like(x)
    partial = torch.empty((lanes * m, lib.pcx_resid_precond_blocks(d)),
                          dtype=torch.float32, device=x.device)
    sumsq = torch.empty(x.shape[:-2], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_resid_precond(
            *(t.data_ptr() for t in args), w.data_ptr(), partial.data_ptr(),
            sumsq.data_ptr(), lanes, m, d, stream)
    _build.check(rc, "resid_precond")
    resid_precond.launches += lanes
    return w, sumsq


resid_precond.launches = 0
