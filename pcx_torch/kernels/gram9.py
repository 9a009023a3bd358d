"""K3 — the fused Rayleigh-Ritz Gram T = [X|W|P]^H [HX|HW|HP].

Replaces the Pallas TPU kernel ``_gram9_kernel`` (``fused_gram9_pairs`` /
``fused_gram9``, ``pcx/operators/pallas_kernels.py:27, :56, :75``), which
the production LOBPCG runs once per iteration when
``solver_opts={"rr_gram": "pallas"}``.  The CUDA source is
``csrc/gram9.cu``; its header states what bounds the kernel on the card and
how the design answers it.

Numerics of the TPU kernel: complex64 operands, one f32 partial per D-chunk
(``chunk``, tail masked), the partials summed in complex128.  A caller with
complex128 iterates rounds them to complex64 first, as ``fused_gram9`` does.

The wrapper also takes a lane axis, for the lanes of a k-point batch:
six (L, m, D) blocks give L Grams (L, 3m, 3m) in ONE launch of the same
two kernels; JAX runs the TPU kernel's batch under ``jax.vmap``.
``gram9.launches`` counts one per lane served.

It takes the plain PyTorch version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  Each launch adds the bytes it must move
(``bytes_moved``) to the program counter ``k3.bytes``.
"""

from __future__ import annotations

import torch

from pcx_torch import tracing
from pcx_torch.kernels import _build
from pcx_torch.kernels.gram_chunks import gram_chunks_plain

NAMES = ("x", "w", "p", "hx", "hw", "hp")


def _check(blocks):
    x = blocks[0]
    if x.dim() not in (2, 3):
        raise ValueError(f"gram9: x must be (m, D) or (L, m, D), got "
                         f"{tuple(x.shape)}")
    for bname, t in zip(NAMES, blocks):
        if t.dtype != torch.complex64 or t.shape != x.shape:
            raise ValueError(f"gram9: {bname} must be complex64 "
                             f"{tuple(x.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"gram9: {bname} is on {t.device}, x on "
                             f"{x.device}")


def bytes_moved(lanes: int, m: int, d: int, chunks: int) -> int:
    """The bytes a launch must move (``csrc/gram9.cu``'s header): the six
    (m, D) complex64 blocks read once, and the complex64 partials, one
    (3m, 3m) a chunk of D, written and read once:
    8 L (6 m D + 2 chunks (3m)^2).  At m=16, D=3*120^3 and 2048-column
    chunks (2532): 3.98 GB of blocks and 0.09 GB of partials."""
    return 8 * lanes * (6 * m * d + 2 * chunks * (3 * m) ** 2)


def gram9_plain(x, w, p, hx, hw, hp, chunk: int = 2048) -> torch.Tensor:
    """Plain PyTorch K3: complex64 ``torch.matmul`` partials per D-chunk of
    the stacked blocks, summed in complex128 (K6's plain version), on
    either shape of ``gram9``."""
    return gram_chunks_plain((x, w, p), (hx, hw, hp), chunk=chunk)


def gram9(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
          hx: torch.Tensor, hw: torch.Tensor, hp: torch.Tensor,
          chunk: int = 2048) -> torch.Tensor:
    """T[r, c] = sum_d conj(S[r, d]) HS[c, d] for S = [x; w; p] and
    HS = [hx; hw; hp], each block complex64 (m, D): complex128 (3m, 3m);
    of each lane of six (L, m, D) blocks: (L, 3m, 3m)."""
    blocks = (x, w, p, hx, hw, hp)
    _check(blocks)
    if chunk <= 0:
        raise ValueError(f"gram9: chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return gram9_plain(*blocks, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"gram9 runs on cpu or cuda, not {x.device}")
    if not all(t.is_contiguous() for t in blocks):
        raise ValueError("gram9: the kernel needs contiguous inputs")
    lib = _build.load()
    lead = x.shape[:-2]
    lanes = x.shape[0] if x.dim() == 3 else 1
    m, d = x.shape[-2:]
    chunks = lib.pcx_gram9_chunks(d, chunk)
    partial = torch.empty((lanes, chunks, 3 * m, 3 * m),
                          dtype=torch.complex64, device=x.device)
    out = torch.empty(lead + (3 * m, 3 * m), dtype=torch.complex128,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_gram9(*(t.data_ptr() for t in blocks),
                           partial.data_ptr(), out.data_ptr(), lanes, m, d,
                           chunk, stream)
    _build.check(rc, "gram9")
    tracing.count("k3.bytes", bytes_moved(lanes, m, d, chunks))
    gram9.launches += lanes
    return out


gram9.launches = 0
