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

``gram9_lanes`` is its lane form for the lockstep k-point batch: six
(L, m, D) blocks give L Grams (L, 3m, 3m) in ONE launch of the same two
kernels; JAX runs the TPU kernel's batch under ``jax.vmap``.

Both wrappers take the plain PyTorch version for CPU tensors only; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from pcx_torch.kernels import _build
from pcx_torch.solvers import rayleigh_ritz as rr

NAMES = ("x", "w", "p", "hx", "hw", "hp")


def _check(blocks, dims: int = 2):
    x = blocks[0]
    name = "gram9" if dims == 2 else "gram9_lanes"
    if x.dim() != dims:
        want = "(m, D)" if dims == 2 else "(L, m, D)"
        raise ValueError(f"{name}: x must be {want}, got {tuple(x.shape)}")
    for bname, t in zip(NAMES, blocks):
        if t.dtype != torch.complex64 or t.shape != x.shape:
            raise ValueError(f"{name}: {bname} must be complex64 "
                             f"{tuple(x.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: {bname} is on {t.device}, x on "
                             f"{x.device}")


def gram9_plain(x, w, p, hx, hw, hp, chunk: int = 2048) -> torch.Tensor:
    """Plain PyTorch K3: complex64 ``torch.matmul`` partials per D-chunk of
    the stacked blocks, summed in complex128 (``rr.gram_f64``).  Takes
    (m, D) blocks or the lane form's (L, m, D)."""
    return rr.gram_f64(torch.cat((x, w, p), dim=-2),
                       torch.cat((hx, hw, hp), dim=-2), chunk=chunk)


def _gram(blocks, chunk: int, name: str, dims: int) -> torch.Tensor:
    """The plain version on the CPU, else the kernel's launch."""
    _check(blocks, dims)
    if chunk <= 0:
        raise ValueError(f"{name}: chunk must be positive, got {chunk}")
    x = blocks[0]
    if x.device.type == "cpu":
        return gram9_plain(*blocks, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if not all(t.is_contiguous() for t in blocks):
        raise ValueError(f"{name}: the kernel needs contiguous inputs")
    lib = _build.load()
    lead = x.shape[:-2]
    lanes = x.shape[0] if dims == 3 else 1
    m, d = x.shape[-2:]
    partial = torch.empty((lanes, lib.pcx_gram9_chunks(d, chunk), 3 * m,
                           3 * m), dtype=torch.complex64, device=x.device)
    out = torch.empty(lead + (3 * m, 3 * m), dtype=torch.complex128,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_gram9(*(t.data_ptr() for t in blocks),
                                 partial.data_ptr(), out.data_ptr(), lanes,
                                 m, d, chunk, stream)
    _build.check(rc, name)
    return out


def gram9(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
          hx: torch.Tensor, hw: torch.Tensor, hp: torch.Tensor,
          chunk: int = 2048) -> torch.Tensor:
    """T[r, c] = sum_d conj(S[r, d]) HS[c, d] for S = [x; w; p] and
    HS = [hx; hw; hp], each block complex64 (m, D): complex128 (3m, 3m)."""
    out = _gram((x, w, p, hx, hw, hp), chunk, "gram9", 2)
    if x.device.type == "cuda":
        gram9.launches += 1
    return out


gram9.launches = 0


def gram9_lanes(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                hx: torch.Tensor, hw: torch.Tensor, hp: torch.Tensor,
                chunk: int = 2048) -> torch.Tensor:
    """``gram9`` of each lane of six complex64 (L, m, D) blocks, in one
    launch: complex128 (L, 3m, 3m)."""
    out = _gram((x, w, p, hx, hw, hp), chunk, "gram9_lanes", 3)
    if x.device.type == "cuda":
        gram9_lanes.launches += 1
    return out


gram9_lanes.launches = 0
