"""Kernel K6 (``pcx_torch.kernels.gram_chunks``, the dense algebra's
chunked Grams) on the CPU: its plain version against the stacked Gram it
replaces, the wrapper's refusals and the bytes each launch counts, and the
solvers that take it (the SVQB projection, the Rayleigh-Ritz step and its
update) against the stacked forms they were written in before K6, bit for
bit.  The kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""

import importlib

import numpy as np
import pytest
import torch

from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.kernels import gram_chunks
from pcx_torch.kernels.block_combine import block_combine_plain
from pcx_torch.lattices import k_path
from pcx_torch.solvers import rayleigh_ritz as rr

k6 = importlib.import_module("pcx_torch.kernels.gram_chunks")


def _stacked_gram(x, y, chunk=0):
    """The complex128-summed Gram of two stacked blocks as ``rr.gram_f64``
    computed it before K6: complex64 (or complex128) ``torch.matmul``
    partials over D-chunks, summed in double, conjugated; lanes one by
    one."""
    if x.dim() > 2:
        return torch.stack([_stacked_gram(a, b, chunk) for a, b in zip(x, y)])
    p, d = x.shape
    q = y.shape[0]
    chunk = chunk or k6.divisor_chunk(d, k6.GRAM_CHUNK)
    nc = -(-d // chunk)
    pad = nc * chunk - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    part = torch.matmul(x.view(p, nc, chunk).transpose(0, 1),
                        y.view(q, nc, chunk).transpose(0, 1).mH)
    acc = torch.complex128 if part.is_complex() else torch.float64
    return torch.conj_physical(part.sum(dim=0, dtype=acc))


def _blocks(rows, d, dtype, lanes=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lead = () if lanes is None else (lanes,)
    return tuple(torch.randn(lead + (r, d), generator=gen, dtype=dtype)
                 for r in rows)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("left,right,d,lanes", [
    ((16, 16, 16), (16, 16, 16), 3 * 8 ** 3, None),   # the Rayleigh-Ritz
    ((5, 5), (5,), 3 * 7 ** 3, None),                 # a projection
    ((4, 3), (6, 2, 1), 1031, None),                  # prime D: padded
    ((6,), (6,), 3 * 6 ** 3, 3),                      # lanes
    ((2, 3), (4, 1), 777, 2)],                        # lanes, ragged D
    ids=["rr", "projection", "ragged", "lanes", "lanes-ragged"])
def test_plain_equals_the_stacked_gram(left, right, d, lanes, dtype):
    """K6's plain version, ``rr.gram_f64`` on the CPU and, for complex64,
    the wrapper, of blocks stacked on each side equal the stacked call of
    before under ``torch.equal``; ``rr.gram`` is its rounding."""
    ls = _blocks(left, d, dtype, lanes, seed=d)
    rs = _blocks(right, d, dtype, lanes, seed=d + 1)
    want = _stacked_gram(torch.cat(ls, -2), torch.cat(rs, -2))
    assert want.dtype == torch.complex128
    assert torch.equal(k6.gram_chunks_plain(ls, rs), want)
    assert torch.equal(rr.gram_f64(ls, rs), want)
    assert torch.equal(rr.gram(ls, rs), want.to(dtype))
    if dtype == torch.complex64:   # the wrapper takes complex64 alone
        assert torch.equal(gram_chunks(ls, rs), want)
        assert torch.equal(gram_chunks(ls, rs, c64=True), want.to(dtype))


def test_plain_takes_an_explicit_chunk_and_real_blocks():
    """``chunk`` reaches the plain version (K3's plain version passes its
    2048), and real blocks sum in float64."""
    x, y = _blocks((4, 4), 4100, torch.complex64, seed=3)
    assert torch.equal(k6.gram_chunks_plain((x,), (y,), chunk=2048),
                       _stacked_gram(x, y, 2048))
    a, b = x.real.contiguous(), y.real.contiguous()
    assert torch.equal(rr.gram_f64(a, b), _stacked_gram(a, b))
    assert rr.gram(a, b).dtype == torch.float32


@pytest.mark.parametrize("case,match", [
    ("stride", "non-unit stride along D"),
    ("blocks", "1 to 3 blocks a side, got 4"),
    ("rows", "49 rows a side"),
    ("d", "the lanes and D of the first left block"),
    ("lanes", "the lanes and D of the first left block"),
    ("dtype", "complex64"),
    ("conj", "lazily conjugated")])
def test_wrapper_names_why_it_refuses(case, match):
    """``problem`` names the reason K6 cannot take the operands, and
    ``gram_chunks`` raises with it, on the CPU too: a block with a
    non-unit stride along D, more than three blocks a side, more rows a
    side than the kernel holds, a D or a lane count that differs from the
    first left block's, another dtype, a lazily conjugated view."""
    x, y = _blocks((8, 8), 600, torch.complex64)
    lx, ly = _blocks((8, 8), 600, torch.complex64, lanes=2)
    lefts, rights = {
        "stride": ((x[:, ::2],), (y[:, ::2],)),
        "blocks": ((x,) * 4, (y,)),
        "rows": ((torch.cat((x,) * 7)[:49],), (y,)),
        "d": ((x,), (y[:, :599],)),
        "lanes": ((lx,), (ly[:1],)),
        "dtype": ((x,), (y.to(torch.complex128),)),
        "conj": ((x,), (y.conj(),)),
    }[case]
    assert match in k6.problem(lefts, rights)
    with pytest.raises(ValueError, match=match):
        gram_chunks(lefts, rights)
    assert k6.problem((x,), (y,)) is None


def test_bytes_read_each_block_once():
    """A launch counts every block once, the right side not at all where
    it is the left (a self-Gram), and its complex128 partials written and
    read: 8 L D (P + Q) + 32 L groups P Q."""
    d = 3 * 120 ** 3
    # one row each, repeated by a zero row stride (K6 takes any row stride)
    x, w, p = (torch.empty((1, d), dtype=torch.complex64).expand(16, d)
               for _ in range(3))
    # 20250 chunks of 256; 2112 partials at 16 x 16, 1056 at 32 x 16
    assert k6.bytes_moved((x,), (w,)) == 8 * d * 32 + 32 * 2112 * 256
    assert k6.bytes_moved((w,), (w,)) == 8 * d * 16 + 32 * 2112 * 256
    assert k6.bytes_moved((x, w), (p,)) == 8 * d * 48 + 32 * 1056 * 512
    assert k6.groups(48, 48, 20250) == 528 and k6.groups(4, 2, 30) == 30
    lx, lw = _blocks((16, 16), 25600, torch.complex64, lanes=3)
    assert (k6.bytes_moved((lx,), (lw,))
            == 3 * k6.bytes_moved((lx[0],), (lw[0],)))


def _stacked_forms(monkeypatch):
    """Put back the stacked forms the solvers used before K6: every
    multi-block Gram and combination concatenates its blocks first and
    takes the stacked Gram of before and one ``torch.matmul``; a row scale
    (the rs loop's W and P scalings) is applied to its block first, as the
    loop did before the kernels took it."""
    def gram_f64(x, y, chunk=0, reduce_axis=None):
        cat = lambda a: a if isinstance(a, torch.Tensor) else torch.cat(
            tuple(a), -2)
        return _stacked_gram(cat(x), cat(y), chunk)

    def combine(blocks, coeffs, addend=None, subtract=False, scale=None):
        if scale is not None:
            addend = rr.scale_cols(addend, scale)
        return block_combine_plain((torch.cat(tuple(blocks), -2),),
                                   (torch.cat(tuple(coeffs), -2),),
                                   addend, subtract)

    monkeypatch.setattr(rr, "gram_f64", gram_f64)
    monkeypatch.setattr(rr, "gram", lambda x, y, reduce_axis=None: gram_f64(
        x, y).to((x if isinstance(x, torch.Tensor) else x[0]).dtype))
    monkeypatch.setattr(rr, "combine", combine)
    monkeypatch.setattr(rr, "_projection",
                        lambda against, block, ra=None, scale=None: [
                            rr.gram(base, block if scale is None
                                    else rr.scale_cols(block, scale))
                            for base in against])


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_svqb_equals_the_stacked_forms(dtype, monkeypatch):
    """``masked_svqb_drop`` against two bases with an H block, two passes,
    lanes and one column masked, at 5 rows (where a CPU BLAS rounds a row
    of a 10-row complex128 product otherwise): the same bits as with the
    stacked Grams and per-base projections of before."""
    gen = torch.Generator().manual_seed(5)
    c = lambda *s: torch.randn(s, generator=gen, dtype=dtype)
    x, w = (rr.masked_svqb_drop(c(2, 5, 777), torch.ones(2, 5), 1e-6)[0]
            for _ in range(2))
    p, hp, hx, hw = c(2, 5, 777), c(2, 5, 777), c(2, 5, 777), c(2, 5, 777)
    mask = torch.ones(2, 5)
    mask[1, 3] = 0.0

    def run():
        return rr.masked_svqb_drop(p, mask, 1e-6, hblock=hp, against=(x, w),
                                   h_against=(hx, hw))

    got = run()
    _stacked_forms(monkeypatch)
    want = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,opts", [
    (torch.complex64, {}), (torch.complex128, {}),
    (torch.complex128, {"w_cap": 3})], ids=["c64", "c128", "c128-wcap"])
def test_rs_solve_equals_the_stacked_forms(dtype, opts, monkeypatch):
    """A short ``lobpcg_sep_rs`` solve at N=12 on the CPU (fcc, nev 4,
    the default ``rr_gram="xla"``: the Rayleigh-Ritz Gram of the six
    blocks and the three-block update; and under a ``w_cap``) equals the
    same solve with the stacked [X|W|P] forms of before, in iterations,
    status, lambdas and x."""
    alpha = k_path("fcc")[9]

    def solve():
        kps = KPointSolver(ProblemConfig(n=12, lattice="fcc", nev=4),
                           device="cpu", dtype=dtype, maxiter=12,
                           refine=False, solver_opts=opts)
        return kps.solve(alpha)

    got = solve()
    _stacked_forms(monkeypatch)
    want = solve()
    assert (got.iterations, got.status) == (want.iterations, want.status)
    assert np.array_equal(got.omega, want.omega)
    assert torch.equal(got.x, want.x)
