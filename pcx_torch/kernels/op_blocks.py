"""K5 — the operator's curl and penalty block multiplies around K2.

Two entry points, each one streaming pass over blocks where they lie:

* ``op_pre(x, d_a)`` = A(-conj d_a) x, the curl block before the forward
  DFT, the negated conjugate symbol formed in registers;
* ``op_post(z, d_a, x, b, shift)`` = (A(d_a) z + H(b) x) + shift x, after
  the inverse DFT (z its output, ``b`` the pnt-scaled penalty
  ``HermSymbol``); without ``b``, A(d_a) z alone (``ama``).

They replace no Pallas kernel (JAX leaves the block multiplies to XLA,
which fuses them); the CUDA source is ``csrc/op_blocks.cu``, whose header
says what bounds the kernel on the card and how the design answers it.
Both round every product and sum where the eager composition
(``op_pre_plain``, ``op_post_plain``: ``blocks.a_block`` and
``blocks.h_block``) rounds it, in its order, so the kernel's result is the
eager one bit for bit.

Operands are complex64 (the penalty's diagonal and a lane shift float32),
contiguous, on one device: blocks (..., 3, N, N, N), symbols (3, N, N, N)
shared by every column, or the lanes of a k-point batch, blocks (L, c, 3, N,
N, N) with symbols (L, 1, 3, N, N, N) and ``shift`` a real (L, 1, 1, 1, 1,
1) tensor.  ``problem`` says why operands lie outside that (None where the
kernel takes them).  Each wrapper takes the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.  Each launch adds
the bytes it reads and writes once to the program counter ``k5.bytes``.
"""

from __future__ import annotations

import array
import math
from typing import Optional

import torch

from pcx_torch import tracing
from pcx_torch.kernels import _build
from pcx_torch.operators.blocks import a_block, h_block
from pcx_torch.operators.symbols import HermSymbol

PRE, POST, POST_PENALTY = 0, 1, 2   # the C entry's kinds


def op_pre_plain(x: torch.Tensor, d_a: torch.Tensor) -> torch.Tensor:
    """Plain K5 pre: the eager composition A(-conj d_a) x."""
    return a_block(x, -d_a.conj())


def op_post_plain(z: torch.Tensor, d_a: torch.Tensor,
                  x: Optional[torch.Tensor] = None,
                  b: Optional[HermSymbol] = None, shift=0.0) -> torch.Tensor:
    """Plain K5 post: the eager composition A(d_a) z, and with ``b``
    (A(d_a) z + H(b) x) + shift x, the shift left out where it is the
    number 0."""
    y = a_block(z, d_a)
    if b is None:
        return y
    y = y + h_block(x, b)
    if isinstance(shift, torch.Tensor) or shift != 0.0:
        y = y + shift * x
    return y


def _refusal(t: torch.Tensor, dev: torch.device, dtype: torch.dtype,
             shape: tuple, name: str) -> Optional[str]:
    if t.dtype != dtype:
        return f"{name} must be {dtype}, got {t.dtype}"
    if t.device != dev:
        return f"{name} is on {t.device}, the block on {dev}"
    if tuple(t.shape) != shape:
        return f"{name} {tuple(t.shape)}: want {shape}"
    if t.is_conj() or t.is_neg():
        return f"{name} is a lazily conjugated or negated view"
    if not t.is_contiguous():
        return f"{name} is not contiguous"
    return None


def problem(x: torch.Tensor, d_a: torch.Tensor,
            b: Optional[HermSymbol] = None, shift=0.0) -> Optional[str]:
    """Why K5 does not take an apply on the block x (the pre's input, the
    post's z and penalty block alike) with these symbols and shift (``b``
    None: ``ama``, the shift unused), or None where it does."""
    if x.dim() < 4 or x.shape[-4] != 3 or x.numel() == 0:
        return f"blocks are (..., 3, N, N, N), got {tuple(x.shape)}"
    dev, comp = x.device, tuple(x.shape[-4:])
    why = _refusal(x, dev, torch.complex64, tuple(x.shape), "the block")
    if why:
        return why
    sym = tuple(d_a.shape)
    if sym != comp and (x.dim() != 6 or sym != (x.shape[0], 1) + comp):
        return (f"symbols {sym}: want {comp}, or (L, 1) + {comp} for "
                f"blocks (L, c) + {comp}")
    why = _refusal(d_a, dev, torch.complex64, sym, "d_a")
    if why or b is None:
        return why
    why = (_refusal(b.diag, dev, torch.float32, sym, "b.diag")
           or _refusal(b.sdiag, dev, torch.complex64, sym, "b.sdiag"))
    if why:
        return why
    if isinstance(shift, torch.Tensor):
        if x.dim() != 6:
            return "a shift tensor goes with blocks (L, c, 3, N, N, N)"
        lanes = sym[0] if len(sym) == 6 else 1
        return _refusal(shift, dev, torch.float32, (lanes,) + (1,) * 5,
                        "shift")
    if not isinstance(shift, (int, float)) or isinstance(shift, bool):
        return f"shift must be a number or a tensor, got {type(shift)}"
    return None


def _meta(x: torch.Tensor, d_a: torch.Tensor, shift) -> tuple:
    """(meta less its kind, shift pointer, shift value) of the C entry for
    operands that ``problem`` passes: meta = [V, columns per symbol lane,
    symbol lanes, has_shift]; the shift is a pointer to the lanes' values
    (a tensor) or the number, has_shift 0 for the number 0."""
    lanes = d_a.shape[0] if d_a.dim() == 6 else 1
    cols = math.prod(x.shape[:-4]) // lanes
    meta = [math.prod(x.shape[-3:]), cols, lanes]
    if isinstance(shift, torch.Tensor):
        return meta + [1], shift.data_ptr(), 0.0
    return meta + [int(shift != 0.0)], 0, float(shift)


def bytes_moved(kind: int, x: torch.Tensor, d_a: torch.Tensor) -> int:
    """The bytes a launch of ``kind`` on the block x (pre's x, post's z)
    with the symbols d_a reads and writes once each: with V = 24 N^3 bytes
    (a column, or a complex symbol) and C columns over S lanes of symbols,
    (2C + S) V for pre and for post without the penalty, (3C + 2.5 S) V
    with it."""
    v, cols, lanes = _meta(x, d_a, 0.0)[0][:3]
    col, c = 24 * v, cols * lanes
    if kind == POST_PENALTY:
        return col * 3 * c + (col * 5 // 2) * lanes
    return col * (2 * c + lanes)


def _launch(kind: int, src: torch.Tensor, x, d_a, b, shift,
            name: str) -> Optional[torch.Tensor]:
    """K5's launch of ``kind`` on the block ``src`` (pre's x, post's z);
    None for CPU operands, which take the plain version."""
    penalty = kind == POST_PENALTY
    why = problem(src, d_a, b if penalty else None, shift)
    if why is None and penalty:
        why = (_refusal(x, src.device, torch.complex64, tuple(src.shape), "x")
               if isinstance(x, torch.Tensor)
               else "the penalty needs the block x")
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if src.device.type == "cpu":
        return None
    if src.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {src.device}")
    meta, shift_ptr, shift_value = _meta(src, d_a, shift if penalty else 0.0)
    out = torch.empty_like(src)
    ptrs = [x.data_ptr() if kind == PRE or penalty else 0,
            0 if kind == PRE else src.data_ptr(), d_a.data_ptr(),
            b.diag.data_ptr() if penalty else 0,
            b.sdiag.data_ptr() if penalty else 0,
            shift_ptr, out.data_ptr()]
    pa, ma = array.array("Q", ptrs), array.array("q", [kind] + meta)
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcx_op_blocks(pa.buffer_info()[0], ma.buffer_info()[0],
                               shift_value, stream)
    _build.check(rc, name)
    tracing.count("k5.bytes", bytes_moved(kind, src, d_a))
    return out


def op_pre(x: torch.Tensor, d_a: torch.Tensor) -> torch.Tensor:
    """A(-conj d_a) x (complex64), the output contiguous like x.  Raises
    ValueError for operands outside the kernel's layout (``problem``)."""
    out = _launch(PRE, x, x, d_a, None, 0.0, "op_pre")
    if out is None:
        return op_pre_plain(x, d_a)
    op_pre.launches += 1
    return out


def op_post(z: torch.Tensor, d_a: torch.Tensor,
            x: Optional[torch.Tensor] = None, b: Optional[HermSymbol] = None,
            shift=0.0) -> torch.Tensor:
    """A(d_a) z, and with ``b`` (A(d_a) z + H(b) x) + shift x (complex64),
    the output contiguous like z.  Raises ValueError for operands outside
    the kernel's layout (``problem``)."""
    kind = POST if b is None else POST_PENALTY
    out = _launch(kind, z, x, d_a, b, shift, "op_post")
    if out is None:
        return op_post_plain(z, d_a, x, b, shift)
    op_post.launches += 1
    return out


op_pre.launches = 0
op_post.launches = 0
