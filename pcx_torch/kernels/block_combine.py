"""K4 — the dense algebra's block combinations in one pass.

``out = A + sum_b C_b^T B_b`` for up to three input blocks B_b (..., p_b,
D), their coefficients C_b (..., p_b, q) and an optional addend A (..., q,
D), with a leading lane axis or without one; ``subtract`` takes A - sum.
An optional real ``scale`` s (..., q), one float32 a row of A, makes the
addend s * A, each element multiplied by its row's scale as K4 loads it
(the rs loop's W and P blocks enter their SVQB so, with no scaled copy).
It serves every combination of the solvers' dense algebra
(``rr.combine``, ``rr.mix``): the SVQB projections and scalings, the
LOBPCG update and the mixes of the complex family, Davidson/JD and the
refines. The CUDA source is ``csrc/block_combine.cu``; its header says why
the kernel exists (it replaces no Pallas kernel), what bounds it on the
card and how the design answers it.

Every block and the addend are read where they lie: they need unit stride
along D and may have any row and lane stride (slices of a stacked block,
the separate X and W blocks), and coefficients may have any strides.  The
wrapper reads nothing back to the host.

``block_combine`` is the one entry point: it checks the operands in one
walk that also builds the C entry's arguments (``problem`` says why a call
lies outside the kernel's limits), takes the plain PyTorch version (the
``torch.matmul`` composition) for CPU tensors only, and for CUDA tensors
launches the kernel or raises.  ``rr.combine`` routes to it by dtype and
size alone.
"""

from __future__ import annotations

import array
from typing import Optional, Sequence

import torch

from pcx_torch import tracing
from pcx_torch.kernels import _build
from pcx_torch.utils import scale_cols

MAX_BLOCKS = 3
MAX_ROWS = 192     # sum of p_b (csrc/block_combine.cu kMaxRows)
MAX_Q = 64         # output rows (kMaxQ)


def _layout(blocks, coeffs, addend, subtract, scale=None):
    """One walk over the operands: (why, ptrs, meta), ``why`` the reason K4
    does not take them (None where it does; ``ptrs`` and ``meta`` are then
    the arrays of the C entry ``pcx_block_combine``, the output's pointer
    left 0)."""
    nb = len(blocks)
    if not 1 <= nb <= MAX_BLOCKS or len(coeffs) != nb:
        return (f"takes 1 to {MAX_BLOCKS} blocks with one coefficient "
                f"matrix each, got {nb} and {len(coeffs)}"), None, None
    b0 = blocks[0]
    shape0 = b0.shape
    dims = len(shape0)
    if dims not in (2, 3):
        return (f"blocks are (p, D) or (L, p, D), got {tuple(shape0)}",
                None, None)
    lanes = dims == 3
    lead, d = shape0[:-2], shape0[-1]
    q = coeffs[0].shape[-1]
    dev = b0.get_device()
    ptrs = [0] * 9
    meta = [nb, shape0[0] if lanes else 1, q, d, int(subtract)] + [0] * 22
    rows = 0
    for k in range(nb):
        b, c = blocks[k], coeffs[k]
        bs, cs = b.shape, c.shape
        if (len(bs) != dims or len(cs) != dims or bs[:-2] != lead
                or cs[:-2] != lead or bs[-1] != d or cs[-2:] != (bs[-2], q)):
            return (f"block {tuple(bs)} with coefficients {tuple(cs)}: want "
                    f"{tuple(lead)} + (p, {d}) and {tuple(lead)} + (p, {q})"
                    ), None, None
        if bs[-2] < 1:
            return "an empty block", None, None
        st, ct = b.stride(), c.stride()
        why = _refusal(b, dev, st) or _refusal(c, dev)
        if why:
            return why, None, None
        rows += bs[-2]
        ptrs[k], ptrs[3 + k] = b.data_ptr(), c.data_ptr()
        meta[5 + k] = bs[-2]
        if lanes:
            meta[8 + 2 * k:10 + 2 * k] = st[:2]
            meta[14 + 3 * k:17 + 3 * k] = ct
        else:
            meta[9 + 2 * k] = st[0]
            meta[15 + 3 * k:17 + 3 * k] = ct
    if addend is not None:
        if addend.shape != lead + (q, d):
            return (f"addend {tuple(addend.shape)}: want {tuple(lead)} + "
                    f"({q}, {d})"), None, None
        st = addend.stride()
        why = _refusal(addend, dev, st)
        if why:
            return why, None, None
        ptrs[6] = addend.data_ptr()
        meta[23:25] = st[:2] if lanes else (0, st[0])
    if scale is not None:
        if addend is None:
            return "a scale without an addend", None, None
        why = scale_refusal(scale, lead + (q,), b0.device)
        if why:
            return why, None, None
        ptrs[8] = scale.data_ptr()
        meta[25:27] = scale.stride() if lanes else (0, scale.stride(0))
    if rows > MAX_ROWS or not 1 <= q <= MAX_Q or d < 1:
        return (f"past the kernel's limits: {rows} rows (at most "
                f"{MAX_ROWS}), {q} outputs (1 to {MAX_Q}), D = {d}"
                ), None, None
    if meta[1] > 65535:
        return f"{meta[1]} lanes (at most 65535)", None, None
    return None, ptrs, meta


def _refusal(t: torch.Tensor, dev: int, strides=None) -> Optional[str]:
    """Why K4 cannot read the operand t (None where it can): ``dev`` is the
    first block's ``get_device()``; a block or the addend passes its
    ``strides``, which need unit stride along D."""
    if t.dtype != torch.complex64:
        return f"operands must be complex64, got {t.dtype}"
    if t.get_device() != dev:
        return f"an operand is on {t.device}, the first block elsewhere"
    if t.is_conj() or t.is_neg():
        return "an operand is a lazily conjugated or negated view"
    if strides is not None and strides[-1] != 1:
        return "a block or the addend has a non-unit stride along D"
    return None


def scale_refusal(s: torch.Tensor, shape, device) -> Optional[str]:
    """Why a kernel cannot read ``s`` as the float32 row scale of shape
    ``shape`` on the operands' ``device`` (None where it can)."""
    if s.dtype != torch.float32:
        return f"a scale must be float32, got {s.dtype}"
    if tuple(s.shape) != tuple(shape):
        return f"scale {tuple(s.shape)}: want {tuple(shape)}, a row each"
    if s.device != device:
        return f"the scale is on {s.device}, the operands on {device}"
    return None


def problem(blocks: Sequence[torch.Tensor], coeffs: Sequence[torch.Tensor],
            addend: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why K4 does not take these operands, or None where it does."""
    return _layout(blocks, coeffs, addend, False, scale)[0]


def block_combine_plain(blocks, coeffs, addend=None, subtract=False,
                        scale=None):
    """Plain PyTorch K4: one ``torch.matmul`` over the blocks stacked (the
    concatenation the kernel does without; like the kernel, it sums the
    rows of all blocks in one product), the addend last, scaled first by
    ``scale`` where one is given (``scale_cols``, the eager complex-by-real
    product).  Takes any dtype and any shapes ``torch.matmul``
    broadcasts."""
    if len(blocks) == 1:
        acc = torch.matmul(coeffs[0].transpose(-2, -1), blocks[0])
    else:
        acc = torch.matmul(torch.cat(tuple(coeffs), -2).transpose(-2, -1),
                           torch.cat(tuple(blocks), -2))
    if addend is not None:
        if scale is not None:
            addend = scale_cols(addend, scale)
        acc = addend - acc if subtract else addend + acc
    return acc


def bytes_moved(blocks, coeffs, addend=None) -> int:
    """The bytes a launch reads and writes once each: every block and the
    addend in, the output out (the coefficients and a scale neglected)."""
    _, ptrs, meta = _layout(blocks, coeffs, addend, False)
    return _bytes(ptrs, meta)


def _bytes(ptrs, meta) -> int:
    """``bytes_moved`` from ``_layout``'s arrays: 8 L D (rows + q), with q
    more rows for an addend."""
    return 8 * meta[1] * meta[3] * (sum(meta[5:8])
                                    + meta[2] * (1 + (ptrs[6] != 0)))


def entry_args(blocks, coeffs, addend, subtract, out, scale=None):
    """The pointer and integer arrays of the C entry ``pcx_block_combine``
    (csrc/block_combine.cu), strides in elements, 0 for an absent
    operand; for operands that ``problem`` passes."""
    _, ptrs, meta = _layout(blocks, coeffs, addend, subtract, scale)
    ptrs[7] = out.data_ptr()
    return ptrs, meta


def _launch(ptrs, meta, b0: torch.Tensor) -> torch.Tensor:
    """K4's launch from ``_layout``'s arrays on CUDA operands (b0 the first
    block)."""
    device = b0.device
    out = torch.empty(tuple(b0.shape[:-2]) + (meta[2], meta[3]),
                      dtype=torch.complex64, device=device)
    ptrs[7] = out.data_ptr()
    pa, ma = array.array("Q", ptrs), array.array("q", meta)
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_block_combine(pa.buffer_info()[0], ma.buffer_info()[0],
                                   stream)
    _build.check(rc, "block_combine")
    block_combine.launches += 1
    tracing.count("k4.bytes", _bytes(ptrs, meta))
    return out


def block_combine(blocks: Sequence[torch.Tensor],
                  coeffs: Sequence[torch.Tensor],
                  addend: Optional[torch.Tensor] = None,
                  subtract: bool = False,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``s * addend +/- sum_b coeffs[b]^T blocks[b]`` (complex64).  Blocks
    (p_b, D) or (L, p_b, D) with unit stride along D, coefficients (p_b, q)
    or (L, p_b, q), the addend (q, D) or (L, q, D), the addend's optional
    float32 row scale s (q,) or (L, q), any strides; outputs contiguous.
    On the card the scaled launch equals the unscaled one on the
    materialised s * addend bit for bit.  Raises ValueError for operands
    outside the kernel's limits (``problem``)."""
    why, ptrs, meta = _layout(blocks, coeffs, addend, subtract, scale)
    if why is not None:
        raise ValueError(f"block_combine: {why}")
    b0 = blocks[0]
    if b0.is_cuda:
        return _launch(ptrs, meta, b0)
    if b0.device.type != "cpu":
        raise ValueError(f"block_combine runs on cpu or cuda, not "
                         f"{b0.device}")
    return block_combine_plain(blocks, coeffs, addend, subtract, scale)


block_combine.launches = 0
