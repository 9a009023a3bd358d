"""K2 — one axis pass of the 3-D DFT, as a mixed-radix FFT.

Replaces the Pallas TPU kernel ``axis_dft_pairs`` (``_axis_dft_kernel``,
``pcx/operators/pallas_kernels.py:288, :323``), six passes of which run in
every operator apply of a complex64 solve (``dft3``).  The TPU kernel
contracts each line with the dense (N, N) twiddle; the CUDA kernel
(``csrc/axis_dft.cu``, whose header states what bounds it on the card and how
the design answers it) computes the same pass as a two-stage Cooley-Tukey FFT
in IEEE f32.  Its entry takes the direction, never a matrix, so no matrix
that is not the DFT reaches it.

The plan (``fft_plan``) is built on the host once per (N, direction): the
factor pair N = N1 * N2 and the three f32 twiddle tables, computed in float64.
``axis_dft`` takes the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  Each launch adds the blocks
resident per SM that the launch computed (two at N=100 to 144, one at
N=150, by shared memory) to the program counter ``k2.sm_blocks``; the plain
version counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from pcx_torch import tracing
from pcx_torch.kernels import _build

MAX_RADIX = 16   # the kernel's register DFTs have length 1..16
MAX_N = 256      # the longest line the kernel takes (csrc/axis_dft.cu kMaxA)


def dft_matrix_np(n: int, inverse: bool) -> np.ndarray:
    """(n, n) complex128 DFT matrix: exp(-2 pi i j k / n), or its conjugate
    over n for the inverse (the normalization of torch.fft.ifftn)."""
    j = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(j, j) / n)
    return w.conj() / n if inverse else w


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """``dft_matrix_np`` cast to complex64 on ``device``: the twiddle of the
    plain version."""
    return torch.as_tensor(dft_matrix_np(n, inverse),
                           device=device).to(torch.complex64)


def factor_pair(n: int) -> tuple:
    """(N1, N2) with N1 * N2 = n, N1 <= N2 <= 16 and N1 nearest sqrt(n); for
    an n with no such pair, (n, 1): one dense stage."""
    for n1 in range(int(np.sqrt(n)), 0, -1):
        if n % n1 == 0 and n // n1 <= MAX_RADIX:
            return n1, n // n1
    return n, 1


class FFTPlan(NamedTuple):
    """The kernel's plan for lines of length n = n1 * n2: complex64 tables
    w1[m] = exp(sigma 2 pi i m / n1), tw[a2, c1] = s exp(sigma 2 pi i a2 c1
    / n) and w2[m] = exp(sigma 2 pi i m / n2), with sigma = -1, s = 1
    forward and sigma = +1, s = 1/n inverse.  Input index a = n2 a1 + a2,
    output index c = c1 + n1 c2."""
    n1: int
    n2: int
    w1: np.ndarray
    tw: np.ndarray
    w2: np.ndarray


@functools.lru_cache(maxsize=None)
def fft_plan(n: int, inverse: bool) -> FFTPlan:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"axis_dft: the kernel takes lines of 1..{MAX_N}, "
                         f"got {n}")
    n1, n2 = factor_pair(n)
    sigma = 1.0 if inverse else -1.0
    scale = 1.0 / n if inverse else 1.0

    def roots(length):
        return np.exp(sigma * 2j * np.pi * np.arange(length) / length)

    tw = scale * np.exp(sigma * 2j * np.pi
                        * np.outer(np.arange(n2), np.arange(n1)) / n)
    return FFTPlan(n1, n2, roots(n1).astype(np.complex64),
                   tw.astype(np.complex64), roots(n2).astype(np.complex64))


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, inverse: bool, device: torch.device) -> tuple:
    plan = fft_plan(n, inverse)
    return tuple(torch.as_tensor(t.ravel(), device=device)
                 for t in (plan.w1, plan.tw, plan.w2))


def plan_flops(n: int) -> float:
    """f32 operations per complex output of the kernel's pass (an FMA counts
    2): the two register DFTs on (a, L - a) pairs and the twiddle, or the
    dense stage."""
    n1, n2 = factor_pair(n)
    if n1 > MAX_RADIX:
        return 8.0 * n + 6.0

    def line(length):   # per line of csrc/axis_dft.cu dft_line<length>
        h = (length - 1) // 2
        even = 4 * h + 4 if length % 2 == 0 else 0
        return 8 * h * h + 10 * h + even

    return line(n1) / n1 + 6.0 + line(n2) / n2


def axis_dft_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: (B, A, J, K) x (A, C) -> (B, J, K, C)."""
    return torch.einsum("bajk,ac->bjkc", x, w).contiguous()


def axis_dft_plain_dir(x: torch.Tensor, inverse: bool = False
                       ) -> torch.Tensor:
    """The plain version told the direction: ``axis_dft_plain`` with the
    complex64 DFT matrix of x's -3rd axis."""
    return axis_dft_plain(x, dft_matrix(x.shape[1], inverse, x.device))


def axis_dft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """y[b, j, k, c] = s sum_a x[b, a, j, k] exp(sigma 2 pi i a c / A) for
    complex64 x (B, A, J, K): one DFT axis pass (forward: sigma = -1, s = 1;
    inverse: sigma = +1, s = 1/A) that writes the transformed axis last."""
    if x.dim() != 4:
        raise ValueError(f"axis_dft: x (B, A, J, K) expected, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.complex64:
        raise ValueError(f"axis_dft computes in complex64, got {x.dtype}")
    if x.device.type == "cpu":
        return axis_dft_plain_dir(x, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"axis_dft runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("axis_dft: the kernel needs a contiguous input")
    b, a, j, k = x.shape
    inverse = bool(inverse)
    plan = fft_plan(a, inverse)
    w1, tw, w2 = _device_tables(a, inverse, x.device)
    lib = _build.load()
    y = torch.empty((b, j, k, a), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_axis_dft(x.data_ptr(), y.data_ptr(), w1.data_ptr(),
                              tw.data_ptr(), w2.data_ptr(), b, a, j, k,
                              plan.n1, plan.n2, stream,
                              ctypes.byref(_PER_SM))
    _build.check(rc, "axis_dft")
    axis_dft.launches += 1
    axis_dft.launches_by_batch[b] = axis_dft.launches_by_batch.get(b, 0) + 1
    tracing.count("k2.sm_blocks", _PER_SM.value)
    return y


axis_dft.launches = 0
axis_dft.launches_by_batch = {}   # batch B -> launches
_PER_SM = ctypes.c_int(0)   # the launch's blocks per SM, the C entry writes
