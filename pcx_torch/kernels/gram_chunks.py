"""K6 — the dense algebra's Grams in one chunked pass.

``G = conj(L R^H)``, ``G[i, j] = sum_d conj(L[i, d]) R[j, d]``, for up to
three row-blocks stacked on the left, L_b (..., p_b, D), and up to three on
the right, R_b (..., q_b, D), complex64, with a leading lane axis or
without one.  It serves every complex64 Gram of the solvers on the card
(``rr.gram_f64`` and its complex64 rounding ``rr.gram``): the SVQB Grams
and projections, the Rayleigh-Ritz Gram of the six blocks of the rs loop,
the Grams of the complex family, Davidson/JD and the light refine.  The
CUDA source is ``csrc/gram_chunks.cu``; its header says why the kernel
exists (it replaces no Pallas kernel), what bounds it on the card and how
the design answers it.

Numerics are F3's (``GRAM_CHUNK``): a float32 partial of each chunk of
``divisor_chunk(D, GRAM_CHUNK)`` columns (the ragged tail masked), the
partials summed in complex128 in the kernel, in a fixed order: the result
is complex128, or rounded to complex64.

Every block is read where it lies: it needs unit stride along D and may
have any row and lane stride (the separate X, W and P blocks, slices of a
stacked block).  Where the right side is the left side (the same tensors)
its rows are read once.  The wrapper reads nothing back to the host.

``gram_chunks`` is the one entry point: it checks the operands in one walk
that also builds the C entry's arguments (``problem`` says why a call lies
outside the kernel's limits), takes the plain PyTorch version
(``gram_chunks_plain``: a ``torch.matmul`` over the chunked view of the
stacked blocks, summed in complex128) for CPU tensors only, and for CUDA
tensors launches the kernel or raises.  ``rr.gram_f64`` routes to it by
dtype, device and size alone.  ``gram_chunks.launches`` counts one per lane
served, and each launch adds the bytes it moves to the program counter
``gram.bytes``.
"""

from __future__ import annotations

import array
from typing import Optional, Sequence

import torch

from pcx_torch import tracing
from pcx_torch.kernels import _build

MAX_BLOCKS = 3
MAX_SIDE = 48      # rows a side, sum of p_b (csrc/gram_chunks.cu kMaxSide)
GROUP_THREADS = 528 * 256    # kGroupThreads


def groups(p: int, q: int, nchunks: int) -> int:
    """The complex128 partials a lane of a (p, q) Gram over ``nchunks``
    chunks, as ``pcx_gram_chunks_groups`` in ``csrc/gram_chunks.cu``
    counts them: ``GROUP_THREADS`` over the threads of the kernel's block
    for the shape (8 or 16 a side, by the side's rows), at most one a
    chunk."""
    side = lambda rows: 8 if rows <= 16 else 16
    return min(nchunks, GROUP_THREADS // (side(p) * side(q)))


# Columns per partial of the Grams.  A single-precision GEMM accumulates
# its k dimension in single precision, so a partial's rounding error grows
# with sqrt(chunk).  On an H100 a (16, 3*120^3) complex64 Gram carried
# 5.3e-6 relative error against complex128 at 65536 columns per partial
# and 3.6e-6 as one GEMM, where the CPU's blocked GEMM keeps ~3e-7; that
# error, times the penalty eigenvalues in the Rayleigh-Ritz matrix, set
# the complex64 residual floor of the solvers on the card (PERF.md, F3).
GRAM_CHUNK = 256


def divisor_chunk(d: int, target: int) -> int:
    """Largest Gram chunk <= target that divides d (so the chunked view needs
    no padding); ``target`` when d has no divisor near it."""
    lo = -(-d // target)
    for nc in range(lo, min(d, 4 * lo) + 1):
        if d % nc == 0:
            return d // nc
    return target


def _stacked(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    return blocks[0] if len(blocks) == 1 else torch.cat(tuple(blocks), -2)


def gram_chunks_plain(lefts: Sequence[torch.Tensor],
                      rights: Sequence[torch.Tensor],
                      chunk: int = 0) -> torch.Tensor:
    """Plain K6: the Gram of the stacked blocks as working-precision
    ``torch.matmul`` partials over D-chunks, summed in double (complex128;
    float64 for real blocks) and conjugated.  ``chunk=0`` picks
    ``divisor_chunk(D, GRAM_CHUNK)``.  Lanes (L, p, D) take one batched
    GEMM each: the chunked view of a lane is a strided batch, that of all
    lanes is not, and one GEMM over them would copy both operands.  Takes
    any dtype and device."""
    x, y = _stacked(lefts), _stacked(rights)
    if x.dim() > 2:
        return torch.stack([gram_chunks_plain((a,), (b,), chunk)
                            for a, b in zip(x, y)])
    p, d = x.shape
    q = y.shape[0]
    chunk = chunk or divisor_chunk(d, GRAM_CHUNK)
    nc = -(-d // chunk)
    pad = nc * chunk - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    xc = x.view(p, nc, chunk).transpose(0, 1)
    yc = y.view(q, nc, chunk).transpose(0, 1)
    # conj(G_c) = X_c Y_c^H: the conjugate rides on the transposed operand.
    part = torch.matmul(xc, yc.mH)
    acc = torch.complex128 if part.is_complex() else torch.float64
    return torch.conj_physical(part.sum(dim=0, dtype=acc))


def _side(blocks, dims, lead, d, dev, meta, ptrs, at: int):
    """Check one side's blocks and fill its entries of the C entry's arrays
    (``at`` 0 for the left side, 1 for the right); (why, rows)."""
    nb = len(blocks)
    if not 1 <= nb <= MAX_BLOCKS:
        return f"takes 1 to {MAX_BLOCKS} blocks a side, got {nb}", 0
    rows = 0
    for k, b in enumerate(blocks):
        bs = b.shape
        if len(bs) != dims or bs[:-2] != lead or bs[-1] != d:
            return (f"block {tuple(bs)}: want {tuple(lead)} + (p, {d}), "
                    f"the lanes and D of the first left block"), 0
        if bs[-2] < 1:
            return "an empty block", 0
        if b.dtype != torch.complex64:
            return f"blocks must be complex64, got {b.dtype}", 0
        if b.get_device() != dev:
            return (f"a block is on {b.device}, the first left block "
                    f"elsewhere"), 0
        if b.is_conj() or b.is_neg():
            return "a block is a lazily conjugated or negated view", 0
        st = b.stride()
        if st[-1] != 1:
            return "a block has a non-unit stride along D", 0
        rows += bs[-2]
        ptrs[3 * at + k] = b.data_ptr()
        meta[8 + 3 * at + k] = bs[-2]
        meta[14 + 6 * at + 2 * k:16 + 6 * at + 2 * k] = (
            st[:2] if dims == 3 else (0, st[0]))
    if rows > MAX_SIDE:
        return (f"past the kernel's limits: {rows} rows a side (at most "
                f"{MAX_SIDE})"), rows
    return None, rows


def _layout(lefts, rights, chunk: int, c64: bool):
    """One walk over the operands: (why, ptrs, meta), ``why`` the reason K6
    does not take them (None where it does; ``ptrs`` and ``meta`` are then
    the arrays of the C entry ``pcx_gram_chunks``, the scratch's and the
    output's pointers left 0)."""
    if not lefts or not rights:
        return "takes at least one block a side", None, None
    shape0 = lefts[0].shape
    dims = len(shape0)
    if dims not in (2, 3):
        return (f"blocks are (p, D) or (L, p, D), got {tuple(shape0)}",
                None, None)
    lead, d = shape0[:-2], shape0[-1]
    dev = lefts[0].get_device()
    lanes = shape0[0] if dims == 3 else 1
    chunk = chunk or divisor_chunk(d, GRAM_CHUNK)
    ptrs = [0] * 8
    meta = [len(lefts), len(rights), lanes, d, chunk, 0, 0, int(c64)] + [0] * 18
    for at, side in enumerate((lefts, rights)):
        why, _ = _side(side, dims, lead, d, dev, meta, ptrs, at)
        if why:
            return why, None, None
    if not 1 <= chunk <= d:
        return f"chunk {chunk} outside 1 to D = {d}", None, None
    if lanes > 65535:
        return f"{lanes} lanes (at most 65535)", None, None
    meta[5] = groups(sum(meta[8:11]), sum(meta[11:14]), -(-d // chunk))
    meta[6] = int(len(lefts) == len(rights) and all(
        a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                   and a.stride() == b.stride())
        for a, b in zip(lefts, rights)))
    return None, ptrs, meta


def problem(lefts: Sequence[torch.Tensor],
            rights: Sequence[torch.Tensor]) -> Optional[str]:
    """Why K6 does not take these operands, or None where it does."""
    return _layout(lefts, rights, 0, False)[0]


def _bytes(meta) -> int:
    """The bytes a launch moves: every block read once (the right side not
    at all where it is the left), the complex128 partials written and read
    once: 8 L D (P + Q) + 32 L groups P Q."""
    lanes, d, ngroups = meta[2], meta[3], meta[5]
    p, q = sum(meta[8:11]), sum(meta[11:14])
    return (8 * lanes * d * (p + (0 if meta[6] else q))
            + 32 * lanes * ngroups * p * q)


def bytes_moved(lefts, rights) -> int:
    """``_bytes`` of operands that ``problem`` passes."""
    return _bytes(_layout(lefts, rights, 0, False)[2])


def _launch(ptrs, meta, b0: torch.Tensor) -> torch.Tensor:
    """K6's two passes from ``_layout``'s arrays on CUDA operands (b0 the
    first left block)."""
    device = b0.device
    lead = tuple(b0.shape[:-2])
    lanes, ngroups = meta[2], meta[5]
    p, q = sum(meta[8:11]), sum(meta[11:14])
    part = torch.empty((lanes, ngroups, p, q), dtype=torch.complex128,
                       device=device)
    out = torch.empty(lead + (p, q), dtype=(torch.complex64 if meta[7]
                                            else torch.complex128),
                      device=device)
    ptrs[6], ptrs[7] = part.data_ptr(), out.data_ptr()
    pa, ma = array.array("Q", ptrs), array.array("q", meta)
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_gram_chunks(pa.buffer_info()[0], ma.buffer_info()[0],
                                 stream)
    _build.check(rc, "gram_chunks")
    gram_chunks.launches += lanes
    tracing.count("gram.bytes", _bytes(meta))
    return out


def gram_chunks(lefts: Sequence[torch.Tensor],
                rights: Sequence[torch.Tensor], chunk: int = 0,
                c64: bool = False) -> torch.Tensor:
    """conj(L R^H) of the stacked left and right blocks, complex128, or
    rounded to complex64 with ``c64``: (P, Q), or (L, P, Q) for blocks with
    a lane axis.  Raises ValueError for operands outside the kernel's
    limits (``problem``)."""
    why, ptrs, meta = _layout(lefts, rights, chunk, c64)
    if why is not None:
        raise ValueError(f"gram_chunks: {why}")
    b0 = lefts[0]
    if b0.is_cuda:
        return _launch(ptrs, meta, b0)
    if b0.device.type != "cpu":
        raise ValueError(f"gram_chunks runs on cpu or cuda, not {b0.device}")
    g = gram_chunks_plain(lefts, rights, chunk)
    return g.to(torch.complex64) if c64 else g


gram_chunks.launches = 0
