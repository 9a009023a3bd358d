"""The W and P column scalings of the rs loop folded into the loads of K4
and K6 (``scale=``): on the CPU the kernels' plain versions apply the
scale eagerly, and every result here equals the composition on the
materialised scaled block under ``torch.equal``.

The loop enters each SVQB with ``s * block``, s = mask / norm a row, where
it used to write ``mask * block`` and its unit-norm copy.  These tests hold
each piece to the materialised form: K4's addend and K6's right side,
``masked_svqb_drop``, the column norms of a masked block, and a whole
``lobpcg_sep_rs`` solve; and the wrappers' refusals of a scale they cannot
read.  The card's kernels are held to the same forms in
``tests/test_torch_gpu.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from pcx_torch import tracing
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.lattices import k_path
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.utils import real_dtype

# the modules (``pcx_torch.kernels`` binds the names to the functions)
k4 = importlib.import_module("pcx_torch.kernels.block_combine")
k6 = importlib.import_module("pcx_torch.kernels.gram_chunks")

D = 3 * 6 ** 3


def _gen(seed):
    gen = torch.Generator().manual_seed(seed)

    def c(*shape, dtype=torch.complex64):
        return torch.randn(shape, generator=gen, dtype=dtype)
    return gen, c


def _unit_scale(block, mask):
    """The loop's scale: the mask over the rows' norms (clamped)."""
    tiny = float(torch.finfo(real_dtype(block.dtype)).tiny ** 0.5)
    lanes = block.dim() > 2
    return mask * (1.0 / rr.colnorms(block, lanes=lanes).clamp(min=tiny))


def _mask(gen, shape, dtype=torch.float32):
    """A 0/1 mask with its first row off (and some others)."""
    m = (torch.rand(shape, generator=gen) > 0.3).to(dtype)
    m[..., 0] = 0.0
    return m


@pytest.mark.parametrize("lanes", [None, 2], ids=["block", "lanes"])
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_k4_scaled_addend_equals_the_materialised_addend(nb, lanes):
    """K4 with a scaled addend, subtracted and added: the call on
    ``scale_cols(addend, s)``, zero rows of s included."""
    gen, c = _gen(10 * nb + (lanes or 0))
    lead = () if lanes is None else (lanes,)
    rows = (16, 16, 8)[:nb]
    blocks = tuple(c(*lead, r, D) for r in rows)
    coeffs = tuple(c(*lead, r, 16) for r in rows)
    add = c(*lead, 16, D)
    s = _unit_scale(add, _mask(gen, lead + (16,)))
    want_add = rr.scale_cols(add, s)
    for sub in (True, False):
        got = k4.block_combine(blocks, coeffs, add, sub, scale=s)
        want = k4.block_combine(blocks, coeffs, want_add, sub)
        assert torch.equal(got, want)
        assert torch.equal(rr.combine(blocks, coeffs, add, sub, scale=s),
                           want)


@pytest.mark.parametrize("lanes", [None, 2], ids=["block", "lanes"])
@pytest.mark.parametrize("nr", [1, 2, 3])
def test_k6_scaled_right_side_equals_the_materialised_side(nr, lanes):
    """K6 with its stacked right rows scaled: the Gram of the scaled
    right blocks, complex128 and rounded, one to three right blocks."""
    gen, c = _gen(20 * nr + (lanes or 0))
    lead = () if lanes is None else (lanes,)
    left = (c(*lead, 16, D), c(*lead, 8, D))
    rights = tuple(c(*lead, r, D) for r in (8, 4, 4)[:nr])
    q = sum(r.shape[-2] for r in rights)
    s = _unit_scale(torch.cat(rights, -2), _mask(gen, lead + (q,)))
    scaled = torch.split(rr.scale_cols(torch.cat(rights, -2), s),
                         [r.shape[-2] for r in rights], dim=-2)
    for c64 in (False, True):
        got = k6.gram_chunks(left, rights, c64=c64, scale=s)
        want = k6.gram_chunks(left, scaled, c64=c64)
        assert torch.equal(got, want)
    assert torch.equal(rr.gram(left, rights, scale=s), rr.gram(left, scaled))
    assert torch.equal(rr.gram_f64(left, scaled),
                       k6.gram_chunks_plain(left, rights, scale=s))


def test_scaled_gathered_w_cap_block():
    """A ``w_cap`` block, gathered rows of a wider one, scaled in K4's
    addend and K6's right side: the calls on the gathered scaled copy."""
    gen, c = _gen(3)
    x, w = c(2, 8, D), c(2, 8, D)
    idx = torch.tensor([[5, 1, 6], [0, 7, 2]])[..., None].expand(-1, -1, D)
    wg = torch.gather(w, 1, idx)
    s = _unit_scale(wg, _mask(gen, (2, 3)))
    coef = rr.gram(x, wg, scale=s)
    want = rr.scale_cols(wg, s)
    assert torch.equal(coef, rr.gram(x, want))
    assert torch.equal(rr.combine((x,), (coef,), wg, True, scale=s),
                       rr.combine((x,), (coef,), want, True))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("passes", [2, 1, 0])
def test_svqb_with_a_scale_equals_the_prescaled_block(dtype, passes):
    """``masked_svqb_drop(block, ..., hblock=hblock, scale=s)`` against two
    bases: the call on ``scale_cols(block, s)`` and the same of hblock, in
    the block, its H block and the mask."""
    gen, c = _gen(int(passes) + 7)
    rd = real_dtype(dtype)
    x, w = (rr.masked_svqb_drop(c(2, 5, D, dtype=dtype), torch.ones(2, 5),
                                1e-6)[0] for _ in range(2))
    hx, hw = c(2, 5, D, dtype=dtype), c(2, 5, D, dtype=dtype)
    p, hp = c(2, 5, D, dtype=dtype), c(2, 5, D, dtype=dtype)
    mask = _mask(gen, (2, 5), rd)
    s = _unit_scale(p, mask)
    kw = dict(against=(x, w), h_against=(hx, hw), passes=passes)
    got = rr.masked_svqb_drop(p, mask, 1e-6, hblock=hp, scale=s, **kw)
    want = rr.masked_svqb_drop(rr.scale_cols(p, s), mask, 1e-6,
                               hblock=rr.scale_cols(hp, s), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_masked_norms_and_the_loop_scalings_of_before(dtype):
    """The norms of a masked block are the masked norms of the block, and
    s * block with s = mask / norm is the loop's composition of before,
    ``scale_cols(mask * block, 1 / norm)``, bit for bit (0/1 masks with
    zero rows)."""
    gen, c = _gen(11)
    rd = real_dtype(dtype)
    tiny = float(torch.finfo(rd).tiny ** 0.5)
    w, hp = c(2, 16, D, dtype=dtype), c(2, 16, D, dtype=dtype)
    for mask in (_mask(gen, (2, 16), rd), torch.zeros(2, 16, dtype=rd)):
        m = mask[..., None]
        masked = m * w
        assert torch.equal(rr.colnorms(masked, lanes=True),
                           rr.colnorms(w, lanes=True) * mask)
        inv = 1.0 / rr.colnorms(masked, lanes=True).clamp(min=tiny)
        s = _unit_scale(w, mask)
        assert torch.equal(rr.scale_cols(masked, inv), rr.scale_cols(w, s))
        # P and H P share the scale of P's norms
        assert torch.equal(inv[..., None] * (m * hp), rr.scale_cols(hp, s))


def _materialising(monkeypatch):
    """Make ``masked_svqb_drop`` write ``scale_cols(block, scale)`` (and of
    hblock) and call itself without the scales."""
    svqb = rr.masked_svqb_drop

    def materialised(block, mask, drop_tol, hblock=None, scale=None, **kw):
        if scale is not None:
            block = rr.scale_cols(block, scale)
            if hblock is not None:
                hblock = rr.scale_cols(hblock, scale)
        return svqb(block, mask, drop_tol, hblock=hblock, **kw)

    monkeypatch.setattr(rr, "masked_svqb_drop", materialised)


@pytest.mark.parametrize("dtype,opts", [
    (torch.complex64, {}), (torch.complex128, {}),
    (torch.complex64, {"w_cap": 3}), (torch.complex64, {"rr_gram": "pallas"})],
    ids=["c64", "c128", "c64-wcap", "c64-pallas"])
def test_rs_solve_equals_the_materialised_scalings(dtype, opts,
                                                    monkeypatch):
    """A short ``lobpcg_sep_rs`` solve at N=10 on the CPU equals the same
    solve with ``masked_svqb_drop`` materialising the scaled blocks, in
    iterations, status, lambdas and x; and counts no ``dense.scaled`` (no
    kernel launched)."""
    alpha = k_path("fcc")[9]

    def solve():
        kps = KPointSolver(ProblemConfig(n=10, lattice="fcc", nev=4),
                           device="cpu", dtype=dtype, maxiter=15,
                           refine=False, solver_opts=opts)
        tracing.reset()
        return kps.solve(alpha)

    got = solve()
    assert tracing.counts().get("dense.scaled", 0) == 0
    _materialising(monkeypatch)
    want = solve()
    assert (got.iterations, got.status) == (want.iterations, want.status)
    assert np.array_equal(got.omega, want.omega)
    assert torch.equal(got.x, want.x)


def test_the_wrappers_refuse_a_scale_they_cannot_read():
    """K4 and K6 name why they refuse a scale: a dtype other than float32,
    a shape other than a row each, another device, and (K4) a scale with
    no addend; ``masked_svqb_drop`` refuses a scale with no base to
    project on (or none for its H block)."""
    gen, c = _gen(13)
    b, coef, add, r = c(4, 64), c(4, 3), c(3, 64), c(5, 64)
    ok3, ok5 = torch.ones(3), torch.ones(5)
    for s, why in ((ok3.double(), "float32"), (torch.ones(4), "a row each"),
                   (torch.ones(1, 3), "a row each"),
                   (torch.ones(3, device="meta"), "the scale is on meta")):
        assert why in k4.problem((b,), (coef,), add, s)
        with pytest.raises(ValueError, match=why):
            k4.block_combine((b,), (coef,), add, scale=s)
    assert "without an addend" in k4.problem((b,), (coef,), None, ok3)
    assert k4.problem((b,), (coef,), add, ok3) is None
    for s, why in ((ok5.half(), "float32"), (ok3, "a row each"),
                   (torch.ones(5, device="meta"), "the scale is on meta")):
        assert why in k6.problem((b,), (r,), s)
        with pytest.raises(ValueError, match=why):
            k6.gram_chunks((b,), (r,), scale=s)
    assert k6.problem((b,), (r,), ok5) is None
    with pytest.raises(ValueError, match="needs its bases"):
        rr.masked_svqb_drop(r, ok5, 1e-6, scale=ok5)
    with pytest.raises(ValueError, match="needs its bases"):
        rr.masked_svqb_drop(r, ok5, 1e-6, hblock=r, against=(b,), scale=ok5)


def test_a_scaled_gram_is_never_a_self_gram():
    """The right side scaled is no longer the left: K6's entry reads it
    (``same`` 0), with the scale's lane and row strides."""
    b = torch.zeros(2, 4, 64, dtype=torch.complex64)
    s = torch.ones(4, 2).T                     # (2, 4), strides (1, 2)
    _, ptrs, meta = k6._layout((b,), (b,), 0, False)
    assert meta[6] == 1 and ptrs[8] == 0 and len(meta) == 28
    _, ptrs, meta = k6._layout((b,), (b,), 0, False, s)
    assert meta[6] == 0 and ptrs[8] == s.data_ptr()
    assert meta[26:28] == [1, 2]
