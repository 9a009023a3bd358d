"""Kernel K5 (``pcx_torch.kernels.op_blocks``, the operator's curl and
penalty block multiplies around K2) on the CPU: its plain versions against
the 3x3 matrices, the operator apply on the CPU (the eager composition as
before: complex128 and the CPU never reach the kernel), the layouts the
kernel reads and the bytes each launch counts.  The kernel itself runs only on
the card (``tests/test_torch_gpu.py``)."""

import pytest
import torch

from pcx_torch import kernels, tracing
from pcx_torch.kernels import op_blocks as k5
from pcx_torch.kernels.op_blocks import (POST, POST_PENALTY, PRE, op_post,
                                         op_post_plain, op_pre, op_pre_plain,
                                         problem)
from pcx_torch.operators import maxwell
from pcx_torch.operators.blocks import a_block, h_block
from pcx_torch.operators.dft import dft3, dft_mats
from pcx_torch.operators.symbols import HermSymbol
from pcx_torch.utils import real_dtype

N = 6


def _operands(c, lanes=None, dtype=torch.complex64, seed=0):
    """x, z (c or (L, c) columns), d_a, b (shared, or (L, 1) lanes) and a
    shift: a number, or a real (L, 1, 1, 1, 1, 1) tensor for lanes."""
    gen = torch.Generator().manual_seed(seed)
    lead = (c,) if lanes is None else (lanes, c)
    slead = () if lanes is None else (lanes, 1)
    comp = (3, N, N, N)

    def cplx(shape):
        return torch.randn(shape, generator=gen, dtype=dtype)

    rdt = real_dtype(dtype)
    b = HermSymbol(torch.rand(slead + comp, generator=gen, dtype=rdt),
                   cplx(slead + comp))
    shift = (0.37 if lanes is None else
             torch.rand((lanes,) + (1,) * 5, generator=gen, dtype=rdt))
    return cplx(lead + comp), cplx(lead + comp), cplx(slead + comp), b, shift


def _eager_post(z, d_a, x, b, shift):
    """The operator's composition after the inverse DFT, as ``ama_bb``
    wrote it before K5: A z + H x, then the shift unless the number 0."""
    y = a_block(z, d_a) + h_block(x, b)
    if isinstance(shift, torch.Tensor) or shift != 0.0:
        y = y + shift * x
    return y


def test_cpu_wrappers_take_the_plain_versions():
    """For CPU tensors ``op_pre`` and ``op_post`` return their plain
    versions and launch nothing; the number 0 leaves the shift out."""
    x, z, d_a, b, shift = _operands(3, lanes=2)
    n0 = (op_pre.launches, op_post.launches)
    assert torch.equal(op_pre(x, d_a), op_pre_plain(x, d_a))
    assert torch.equal(op_post(z, d_a), op_post_plain(z, d_a))
    assert torch.equal(op_post(z, d_a, x, b, shift),
                       op_post_plain(z, d_a, x, b, shift))
    assert (op_pre.launches, op_post.launches) == n0
    assert torch.equal(op_post_plain(z, d_a, x, b, 0.0),
                       a_block(z, d_a) + h_block(x, b))


@pytest.mark.parametrize("penalty", [True, False], ids=["ama_bb", "ama"])
@pytest.mark.parametrize("c,lanes", [(1, None), (3, None), (16, None),
                                     (3, 2)], ids=["c1", "c3", "c16", "L2"])
def test_plain_versions_are_the_block_matrices(c, lanes, penalty):
    """In complex128, pre is the matrix A(-conj d) and post A(d) z, with
    the penalty A(d) z + (H(b) + shift) x, where A(d) = [[0, -d2, d1],
    [d2, 0, -d0], [-d1, d0, 0]] and H the Hermitian block of ``b`` (diag,
    (s12, s13, s23))."""
    x, z, d, b, shift = _operands(c, lanes, dtype=torch.complex128, seed=c)

    def curl(s):
        zero = torch.zeros_like(s[..., 0, :, :, :])
        s0, s1, s2 = s.unbind(-4)
        return torch.stack([torch.stack(r, -4) for r in (
            (zero, -s2, s1), (s2, zero, -s0), (-s1, s0, zero))], -5)

    dg, (s12, s13, s23) = b.diag.to(z.dtype).unbind(-4), b.sdiag.unbind(-4)
    herm = torch.stack([torch.stack(r, -4) for r in (
        (dg[0], s12, s13), (s12.conj(), dg[1], s23),
        (s13.conj(), s23.conj(), dg[2]))], -5)
    eye = torch.eye(3, dtype=z.dtype).reshape(3, 3, 1, 1, 1)
    herm = herm + shift[..., None] * eye if lanes else herm + shift * eye

    def apply(m, v):            # m (..., 3, 3, N, N, N), v (..., 3, N, N, N)
        return (m * v.unsqueeze(-5)).sum(-4)

    tol = dict(rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(op_pre_plain(x, d),
                               apply(curl(-d.conj()), x), **tol)
    if penalty:
        torch.testing.assert_close(op_post_plain(z, d, x, b, shift),
                                   apply(curl(d), z) + apply(herm, x), **tol)
    else:
        torch.testing.assert_close(op_post_plain(z, d), apply(curl(d), z),
                                   **tol)


@pytest.mark.parametrize("dtype,lanes", [(torch.complex64, None),
                                         (torch.complex64, 2),
                                         (torch.complex128, None)],
                         ids=["c64", "c64-lanes", "c128"])
def test_operator_apply_is_unchanged_and_never_reaches_k5(dtype, lanes,
                                                          monkeypatch):
    """``ama_bb`` and ``ama`` on the CPU equal the eager composition bit
    for bit (the DFT of a complex64 apply through ``dft3``, of complex128
    through torch.fft) and launch nothing."""
    def refuse(*a, **k):
        raise AssertionError("K5 reached from the CPU")

    monkeypatch.setattr(k5, "op_pre", refuse)
    monkeypatch.setattr(k5, "op_post", refuse)
    x, _, d_a, b, shift = _operands(3, lanes, dtype=dtype, seed=11)
    eps = torch.rand((N, N, N), generator=torch.Generator().manual_seed(1),
                     dtype=real_dtype(dtype)) + 0.5
    mats = dft_mats(N, dtype, "cpu") if dtype == torch.complex64 else None

    def diel(v):
        return v * eps

    def ama_eager(v):
        y = a_block(v, -d_a.conj())
        lead = y.shape[:-4]
        y = y.reshape((-1,) + y.shape[-4:])
        y = (torch.fft.fftn(y, dim=(-3, -2, -1)) if mats is None
             else dft3(y, mats))
        y = diel(y)
        y = (torch.fft.ifftn(y, dim=(-3, -2, -1)) if mats is None
             else dft3(y, mats, inverse=True))
        return y.reshape(lead + y.shape[-4:])

    kernels.reset_launches()
    z = ama_eager(x)
    assert torch.equal(maxwell.ama(x, d_a, diel, mats), a_block(z, d_a))
    assert torch.equal(maxwell.ama_bb(x, d_a, b, diel, shift, mats),
                       _eager_post(z, d_a, x, b, shift))
    got = tracing.counts()
    assert got["op.applies"] == 2 and "k5.bytes" not in got


def _refused_cases():
    x, z, d, b, _ = _operands(2)
    xl, _, dl, bl, sl = _operands(2, lanes=2)
    return {
        "complex128 block": (x.to(torch.complex128), d, None, 0.0),
        "transposed block": (x.transpose(-1, -2), d, None, 0.0),
        "conjugated symbol": (x, d.conj(), None, 0.0),
        "negated symbol": (x, torch._neg_view(d), None, 0.0),
        "symbol shape": (x, d[..., :-1], None, 0.0),
        "lane symbols on one lane": (x, dl, None, 0.0),
        "complex diagonal": (x, d, HermSymbol(b.sdiag, b.sdiag), 0.0),
        "strided off-diagonal": (x, d, HermSymbol(b.diag, b.sdiag.mT), 0.0),
        "shift tensor without lanes": (x, d, b, torch.ones(1, 1, 1, 1, 1)),
        "shift of the wrong lanes": (xl, dl, bl, sl[:1]),
        "float64 shift": (xl, dl, bl, sl.double()),
        "bool shift": (x, d, b, True),
    }


@pytest.mark.parametrize("case", list(_refused_cases()))
def test_problem_names_what_k5_cannot_read(case):
    """``problem`` refuses each operand K5 cannot read, and the wrappers
    raise on it."""
    x, d, b, shift = _refused_cases()[case]
    why = problem(x, d, b, shift)
    assert why
    with pytest.raises(ValueError):
        if b is None:
            op_pre(x, d)
        else:
            op_post(x, d, x, b, shift)


@pytest.mark.parametrize("lanes,shift", [(None, 0.0), (None, 2.5),
                                         (2, "lanes"), (2, 1.25)])
def test_problem_takes_the_operators_layouts(lanes, shift):
    x, _, d, b, sl = _operands(3, lanes)
    shift = sl if shift == "lanes" else shift
    assert problem(x, d) is None
    assert problem(x, d, b, shift) is None
    # every column under one lane axis, one symbol shared
    assert problem(x.reshape((1, -1) + x.shape[-4:]),
                   d.reshape((-1,) + d.shape[-4:])[0]) is None


def test_the_penalty_needs_its_block():
    x, z, d, b, _ = _operands(2)
    with pytest.raises(ValueError, match="block x"):
        op_post(z, d, None, b)
    with pytest.raises(ValueError, match="x"):
        op_post(z, d, x[:1], b)


def test_bytes_count_each_operand_once():
    """A launch's ``k5.bytes``: with V = 24 N^3 bytes and C columns over S
    lanes of symbols, (2C + S) V for pre and post without the penalty,
    (3C + 2.5 S) V with it; and the C entry's lanes and columns."""
    v = 24 * 120 ** 3

    def meta(*shape):           # shapes alone, no storage
        return torch.empty(shape, dtype=torch.complex64, device="meta")

    blk, sym = meta(16, 3, 120, 120, 120), meta(3, 120, 120, 120)
    assert k5.bytes_moved(PRE, blk, sym) == 33 * v
    assert k5.bytes_moved(POST, blk, sym) == 33 * v
    assert k5.bytes_moved(POST_PENALTY, blk, sym) == 50.5 * v
    assert k5.bytes_moved(PRE, blk[:4], sym) == 9 * v
    lanes = meta(4, 16, 3, 120, 120, 120), meta(4, 1, 3, 120, 120, 120)
    assert k5.bytes_moved(POST_PENALTY, *lanes) == (3 * 64 + 10) * v
    x, _, d, _, sl = _operands(5, lanes=2)
    assert k5._meta(x, d, sl)[0] == [N ** 3, 5, 2, 1]
    assert k5._meta(x[0], d[0, 0], 0.0) == ([N ** 3, 5, 1, 0], 0, 0.0)
