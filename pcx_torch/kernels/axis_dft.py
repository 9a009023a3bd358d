"""K2 — one axis pass of the matmul 3-D DFT.

Replaces the Pallas TPU kernel ``axis_dft_pairs`` (``_axis_dft_kernel``,
``pcx/operators/pallas_kernels.py:288, :323``), six passes of which run in
every operator apply of a complex64 solve (``dft3``).  The CUDA source is
``csrc/axis_dft.cu``; its header states what bounds the kernel on the card
and how the design answers it.

``axis_dft`` takes the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pcx_torch.kernels import _build


def axis_dft_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: (B, A, J, K) x (A, C) -> (B, J, K, C)."""
    return torch.einsum("bajk,ac->bjkc", x, w).contiguous()


def axis_dft(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[b, j, k, c] = sum_a x[b, a, j, k] w[a, c] for complex64 x
    (B, A, J, K) and twiddle w (A, C): one DFT axis pass that writes the
    transformed axis last."""
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"axis_dft: x (B, A, J, K) and w (A, C) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.complex64 or w.dtype != torch.complex64:
        raise ValueError(f"axis_dft computes in complex64, got {x.dtype} "
                         f"and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return axis_dft_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"axis_dft runs on cpu or cuda, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("axis_dft: the kernel needs contiguous inputs")
    lib = _build.load()
    b, a, j, k = x.shape
    c = w.shape[1]
    y = torch.empty((b, j, k, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_axis_dft(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              b, a, j, k, c, stream)
    _build.check(rc, "axis_dft")
    axis_dft.launches += 1
    return y


axis_dft.launches = 0
