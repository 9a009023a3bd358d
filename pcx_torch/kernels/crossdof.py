"""K7 — the cross-DoF eps^{-1} apply in one pass.

``crossdof_apply(x, diag, masks, sten, eps)`` is ``CrossDofOp``'s apply:
y = x diag plus, for each nonzero off-diagonal entry e of the pairs 12, 13
and 23, the row block (e/2)(R_row T + T R_col) on x_col and its conjugate
transpose on x_row, T the pair's separable 2k-tap averaging (the eager
composition ``dielectric.make_crossdof_apply``).  One launch reads x's
three components, the diagonal and the masks the nonzero pairs read, and
writes y once; the rolls become neighbour reads through the L1 cache, and
the T chains and the partial sums stay in registers.

It replaces no Pallas kernel (the JAX package leaves this stencil to XLA);
the CUDA source is ``csrc/crossdof.cu``, whose header says what bounds the
kernel on the card (the bytes) and how the design answers it.  It rounds
every product and sum where the eager composition (``crossdof_plain``)
rounds it, in its order, so the kernel's result is the eager one bit for
bit.

Operands: x complex64, contiguous, (..., 3, N, N, N) with any leading axes
(a block, the lanes of a k-point batch); diag and masks float32, contiguous,
(3, N, N, N), on x's device; a stencil of 2k taps, k <= ``MAX_K``; three
eps entries, a zero entry skipping its pair.  ``problem`` says why operands
lie outside that (None where the kernel takes them).  The wrapper takes the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises.  Each launch adds the bytes it must read and write to the
program counter ``k7.bytes``, and a launch whose nonzero pairs include 13
or 23 (``IAXIS``: a transposed average along i, the grid's fastest axis)
adds the same bytes to ``k7.iaxis_bytes``.
"""

from __future__ import annotations

import array
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from pcx_torch import tracing
from pcx_torch.kernels import _build
from pcx_torch.kernels.op_blocks import _refusal

MAX_K = 3                  # taps 2k <= 6 (the C entry's kMaxK)
MAX_N = 1290               # N^2 offsets in 32 bits (the C entry's limit)
IAXIS = 0b110              # the pairs 13 and 23 as ``_terms``' bits


def crossdof_plain(x: torch.Tensor, diag: torch.Tensor, masks: torch.Tensor,
                   sten: Sequence[float], eps: Sequence[complex]
                   ) -> torch.Tensor:
    """Plain K7: the eager composition (torch.roll arithmetic)."""
    from pcx_torch.operators.dielectric import make_crossdof_apply
    return make_crossdof_apply(tuple(sten), *eps)((diag, masks), x)


@functools.lru_cache(maxsize=None)
def _terms(sten: tuple, eps: tuple) -> tuple:
    """(active pairs as bits, the C entry's float parameters: the taps in
    six slots, then re, im of 0.5 e of each pair in float32)."""
    active = sum(1 << p for p, e in enumerate(eps) if complex(e) != 0)
    taps = list(sten) + [0.0] * (2 * MAX_K - len(sten))
    half = [0.5 * complex(e) for e in eps]
    vals = taps + [v for h in half for v in (h.real, h.imag)]
    return active, array.array("f", np.float32(vals).tolist())


def masks_read(active: int) -> int:
    """The edge masks the nonzero pairs read: one per component in some
    nonzero pair."""
    comps = {c for p, rc in enumerate(((0, 1), (0, 2), (1, 2)))
             if active >> p & 1 for c in rc}
    return len(comps)


def problem(x: torch.Tensor, diag: torch.Tensor, masks: torch.Tensor,
            sten: Sequence[float], eps: Sequence[complex]) -> Optional[str]:
    """Why K7 does not take this apply, or None where it does."""
    n = x.shape[-1] if x.dim() else 0
    if (x.dim() < 4 or x.shape[-4] != 3 or x.numel() == 0
            or tuple(x.shape[-3:]) != (n, n, n)):
        return f"fields are (..., 3, N, N, N), got {tuple(x.shape)}"
    if n > MAX_N:
        return f"N={n}: K7 takes N <= {MAX_N}"
    if len(sten) % 2 or not 2 <= len(sten) <= 2 * MAX_K:
        return (f"the stencil has {len(sten)} taps: K7 takes 2k taps, "
                f"k <= {MAX_K}")
    if len(eps) != 3:
        return f"three eps entries (12, 13, 23), got {len(eps)}"
    dev = x.device
    return (_refusal(x, dev, torch.complex64, tuple(x.shape), "the field")
            or _refusal(diag, dev, torch.float32, (3, n, n, n), "diag")
            or _refusal(masks, dev, torch.float32, (3, n, n, n), "masks"))


def bytes_moved(x: torch.Tensor, active: int) -> int:
    """The bytes an apply must move: x read and y written once (48 bytes a
    grid point and column), the diagonal and the masks the nonzero pairs
    read once (4 bytes a point each): (48 c + 4 (3 + masks)) N^3."""
    cols = math.prod(x.shape[:-4])
    return (48 * cols + 4 * (3 + masks_read(active))) * math.prod(
        x.shape[-3:])


def crossdof_apply(x: torch.Tensor, diag: torch.Tensor, masks: torch.Tensor,
                   sten: Sequence[float], eps: Sequence[complex]
                   ) -> torch.Tensor:
    """The cross-DoF eps^{-1} apply (complex64), the output contiguous like
    x.  Raises ValueError for operands outside the kernel's layout
    (``problem``)."""
    why = problem(x, diag, masks, sten, eps)
    if why is not None:
        raise ValueError(f"crossdof_apply: {why}")
    if x.device.type == "cpu":
        return crossdof_plain(x, diag, masks, sten, eps)
    if x.device.type != "cuda":
        raise ValueError(f"crossdof_apply runs on cpu or cuda, not {x.device}")
    sten = tuple(float(w) for w in sten)
    active, params = _terms(sten, tuple(complex(e) for e in eps))
    out = torch.empty_like(x)
    pa = array.array("Q", [x.data_ptr(), diag.data_ptr(), masks.data_ptr(),
                           out.data_ptr()])
    ma = array.array("q", [x.shape[-1], math.prod(x.shape[:-4]),
                           len(sten) // 2, active])
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_crossdof(pa.buffer_info()[0], ma.buffer_info()[0],
                              params.buffer_info()[0], stream)
    _build.check(rc, "crossdof_apply")
    nbytes = bytes_moved(x, active)
    tracing.count("k7.bytes", nbytes)
    if active & IAXIS:
        tracing.count("k7.iaxis_bytes", nbytes)
    crossdof_apply.launches += 1
    return out


crossdof_apply.launches = 0
