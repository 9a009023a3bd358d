"""Kernels K1 (resid_precond), K2 (axis_dft / dft3) and K3 (gram9) of the
port.

On the CPU the wrappers take their plain PyTorch versions, which are held
against the JAX Pallas kernels run in interpret mode (as tests/test_pallas.py
runs them).  The CUDA kernels themselves are held against the plain versions
in tests/test_torch_gpu.py.  K2's FFT on the card (csrc/axis_dft.cu) is
emulated here in float32 from its plan's own factor pair and twiddle tables,
and the 3xTF32 split that K3 computes with on the card's tensor cores
(csrc/tf32x3.cuh) likewise; both are held against complex128 at the card
tests' tolerances.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from pcx.operators import dft as jdft
from pcx.operators.pallas_kernels import (dft3_pairs_fused, fused_gram9_pairs,
                                          fused_resid_precond)
from pcx_torch.kernels import axis_dft, gram9, resid_precond
from pcx_torch.kernels.axis_dft import (dft_matrix_np, factor_pair, fft_plan,
                                        plan_flops)
from pcx_torch.operators.dft import dft3, dft_mats


def _k1_inputs(rng, m, d):
    c = lambda *s: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(
        np.complex64)
    return (c(m, 3, d), c(m, 3, d), rng.normal(size=(m,)).astype(np.float32),
            rng.normal(size=(3, d)).astype(np.float32), c(3, d))


def test_k1_plain_matches_pallas_interpret(rng):
    # D=1537 is not a multiple of the Pallas chunk: the padded tail counts.
    m, d = 5, 1537
    x, hx, lam, idg, isd = _k1_inputs(rng, m, d)
    pair = lambda a: (jnp.asarray(a.real), jnp.asarray(a.imag))
    (wr, wi), ss = fused_resid_precond(pair(x), pair(hx), jnp.asarray(lam),
                                       jnp.asarray(idg), pair(isd),
                                       chunk=512, interpret=True)
    w, sumsq = resid_precond(*(torch.as_tensor(a) for a in
                               (x, hx, lam, idg, isd)))
    assert w.dtype == torch.complex64 and sumsq.dtype == torch.float32
    # f32 on both sides, summed in another order (tests/test_pallas.py:94-99)
    np.testing.assert_allclose(np.sqrt(sumsq.numpy()), np.sqrt(np.asarray(ss)),
                               rtol=2e-5)
    np.testing.assert_allclose(w.numpy().real, np.asarray(wr), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(w.numpy().imag, np.asarray(wi), rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("n,lead", [(8, (2, 3)), (10, (4,)), (12, (2,))])
def test_k2_plain_dft3_matches_pallas_interpret(rng, n, lead, direction):
    w_np = getattr(jdft.dft_mats(n, np.complex128), direction)
    x = (rng.standard_normal(lead + (n, n, n))
         + 1j * rng.standard_normal(lead + (n, n, n))).astype(np.complex64)
    w32 = (jnp.asarray(w_np.real, jnp.float32),
           jnp.asarray(w_np.imag, jnp.float32))
    ref = dft3_pairs_fused((jnp.asarray(x.real), jnp.asarray(x.imag)), w32,
                           interpret=True)
    ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    mats = dft_mats(n, torch.complex64, "cpu")
    got = dft3(torch.as_tensor(x), mats, inverse=direction == "inv").numpy()
    # f32 products summed in another order: 5e-6 of the output scale
    # (tests/test_pallas.py:188-192)
    np.testing.assert_allclose(got, ref, atol=5e-6 * np.abs(ref).max())


@pytest.mark.parametrize("n", [8, 12])
def test_dft3_complex128_matches_torch_fft(rng, n):
    x = torch.as_tensor(rng.standard_normal((3, n, n, n))
                        + 1j * rng.standard_normal((3, n, n, n)))
    mats = dft_mats(n, torch.complex128, "cpu")
    axes = (-3, -2, -1)
    fwd = torch.fft.fftn(x, dim=axes)
    np.testing.assert_allclose(dft3(x, mats).numpy(), fwd.numpy(),
                               atol=1e-12 * float(fwd.abs().max()))
    np.testing.assert_allclose(dft3(fwd, mats, inverse=True).numpy(),
                               x.numpy(), atol=1e-12 * float(x.abs().max()))


def test_dft3_complex64_forward_then_inverse_returns_x(rng):
    n = 12
    x = torch.as_tensor((rng.standard_normal((2, n, n, n))
                         + 1j * rng.standard_normal((2, n, n, n))
                         ).astype(np.complex64))
    mats = dft_mats(n, torch.complex64, "cpu")
    back = dft3(dft3(x, mats), mats, inverse=True)
    assert back.dtype == torch.complex64
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=5e-6 * float(x.abs().max()))


def _k3_blocks(rng, m, d):
    return [(rng.normal(size=(m, d)) + 1j * rng.normal(size=(m, d))).astype(
        np.complex64) for _ in range(6)]


@pytest.mark.parametrize("m,d,chunk", [(4, 5000, 1024),
                                       (3, 1537, 512)])   # ragged tail
def test_k3_plain_matches_pallas_interpret(rng, m, d, chunk):
    blocks = _k3_blocks(rng, m, d)
    t_re, t_im = fused_gram9_pairs(
        *((jnp.asarray(a.real), jnp.asarray(a.imag)) for a in blocks),
        chunk=chunk, interpret=True)
    want = np.asarray(t_re) + 1j * np.asarray(t_im)
    got = gram9(*(torch.as_tensor(a) for a in blocks), chunk=chunk)
    assert got.dtype == torch.complex128 and got.shape == (3 * m, 3 * m)
    # f32 chunk partials on both sides, summed in f64 (tests/test_pallas.py:27)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_wrappers_count_only_kernel_launches(rng):
    x, hx, lam, idg, isd = (torch.as_tensor(a)
                            for a in _k1_inputs(rng, 2, 64))
    before = (resid_precond.launches, axis_dft.launches, gram9.launches)
    resid_precond(x, hx, lam, idg, isd)
    axis_dft(torch.zeros((2, 4, 4, 4), dtype=torch.complex64))
    axis_dft(torch.zeros((2, 4, 4, 4), dtype=torch.complex64), True)
    gram9(*(torch.as_tensor(a) for a in _k3_blocks(rng, 2, 100)))
    assert (resid_precond.launches, axis_dft.launches,
            gram9.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    x, hx, lam, idg, isd = (torch.as_tensor(a)
                            for a in _k1_inputs(rng, 2, 64))
    with pytest.raises(ValueError, match="complex64"):
        axis_dft(torch.zeros((1, 4, 4, 4), dtype=torch.complex128))
    with pytest.raises(ValueError, match=r"\(B, A, J, K\)"):
        axis_dft(torch.zeros((4, 4, 4), dtype=torch.complex64))
    with pytest.raises(ValueError, match="lines of 1..256"):
        fft_plan(257, False)
    with pytest.raises(ValueError, match="lam"):
        resid_precond(x, hx, lam.double(), idg, isd)
    with pytest.raises(ValueError, match="inv_sd"):
        resid_precond(x, hx, lam, idg, isd[:, :10])
    blocks = [torch.as_tensor(a) for a in _k3_blocks(rng, 2, 100)]
    with pytest.raises(ValueError, match="hw must be complex64"):
        gram9(*blocks[:4], blocks[4].to(torch.complex128), blocks[5])
    with pytest.raises(ValueError, match="p must be complex64"):
        gram9(blocks[0], blocks[1], blocks[2][:, :50], *blocks[3:])


# --- the 3xTF32 split of csrc/tf32x3.cuh, emulated on float32 -------------


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits -- half a TF32 ulp added to the sign-magnitude bits, the
    low 13 cleared (integer ops on the bit view, as K3 does)."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _mma3(a, b, d):
    """d + a @ b as three TF32 products, small ones first: lo*hi, hi*lo,
    hi*hi, each exact in f32 and summed over the k8 step in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    for p, q in ((al, bh), (ah, bl), (ah, bh)):
        d = d + p @ q
    return d


def _mma1(a, b, d):
    """d + a @ b in single-pass TF32: what the kernels must not do."""
    return d + _tf32(a) @ _tf32(b)


def _cmma(ar, ai, br, bi, mma):
    """One k8 step's complex product conj(A) B, formed in fresh f32 sums
    (the kernel adds it to its running sums afterwards)."""
    zero = torch.zeros(ar.shape[:-1] + br.shape[-1:])
    return (mma(ai, bi, mma(ar, br, zero)),
            mma(-ai, br, mma(ar, bi, zero)))


def _k3_emulated(blocks, chunk, mma):
    """K3 on the tensor cores: one f32 partial of conj(S) HS^T per D-chunk
    (k8 steps added to f32 sums), the partials summed in complex128."""
    s, hs = torch.cat(blocks[:3]), torch.cat(blocks[3:])
    out = torch.zeros((s.shape[0],) * 2, dtype=torch.complex128)
    for c0 in range(0, s.shape[1], chunk):
        pad = -min(chunk, s.shape[1] - c0) % 8
        part = [F.pad(t[:, c0:c0 + chunk], (0, pad))
                for t in (s.real, s.imag, hs.real, hs.imag)]
        re = im = 0.0
        for d0 in range(0, part[0].shape[1], 8):
            sr, si, hr, hi = (t[:, d0:d0 + 8] for t in part)
            tr, ti = _cmma(sr, si, hr.T, hi.T, mma)
            re, im = re + tr, im + ti
        out += torch.complex(re, im).to(torch.complex128)
    return out


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10   # TF32 keeps 10 mantissa bits
    a = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + 0.49 * one_ulp, 1.0 + 1.5 * one_ulp, 3.0e-3])
    got = _tf32(a)
    assert got[:4].tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0,
                                1.0 + 2 * one_ulp]
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


@pytest.mark.parametrize("m,d,chunk", [(5, 4099, 512),
                                       (16, 3 * 16 ** 3 + 37, 2048)])
def test_k3_3xtf32_split_keeps_f32_accuracy(rng, m, d, chunk):
    """Ragged D: the split's error against complex128 stays inside the card
    test's 1e-5 of max|T|; single-pass TF32 does not."""
    blocks = [torch.as_tensor(a) for a in _k3_blocks(rng, m, d)]
    s, hs = torch.cat(blocks[:3]), torch.cat(blocks[3:])
    want = s.to(torch.complex128).conj() @ hs.to(torch.complex128).T
    scale = float(want.abs().max())
    err = lambda mma: float((_k3_emulated(blocks, chunk, mma)
                             - want).abs().max())
    assert err(_mma3) <= 1e-5 * scale
    assert err(_mma1) > 1e-5 * scale


# --- K2's FFT plan, emulated on float32 -----------------------------------


def _dft_line(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """csrc/axis_dft.cu ``dft_line<L>`` along the last axis of complex64 v
    (length L), w[m] = exp(sigma 2 pi i m / L): the pairs (a, L - a) as
    s_a = v[a] + v[L-a] and d_a = v[a] - v[L-a], out[c] = re + i im and
    out[L-c] = re - i im with re = v[0] + sum s_a Re w[ac] (and the
    (-1)^c v[L/2] of an even L), im = sum d_a Im w[ac]."""
    length = v.shape[-1]
    h, even = (length - 1) // 2, length % 2 == 0
    col = [v[..., a] for a in range(length)]
    s = {a: col[a] + col[length - a] for a in range(1, h + 1)}
    d = {a: col[a] - col[length - a] for a in range(1, h + 1)}
    out = [None] * length
    acc = col[0]
    for a in range(1, h + 1):
        acc = acc + s[a]
    out[0] = acc + col[length // 2] if even else acc
    if even:
        e = col[0]
        for a in range(1, h + 1):
            e = e - s[a] if a % 2 else e + s[a]
        half = col[length // 2]
        out[length // 2] = e - half if (length // 2) % 2 else e + half
    for c in range(1, h + 1):
        re, im = col[0], torch.zeros_like(col[0])
        if even:
            half = col[length // 2]
            re = re - half if c % 2 else re + half
        for a in range(1, h + 1):
            t = w[(a * c) % length]
            re = re + s[a] * t.real
            im = im + d[a] * t.imag
        out[c], out[length - c] = re + 1j * im, re - 1j * im
    return torch.stack(out, -1)


def _k2_fft_emulated(x: torch.Tensor, plan) -> torch.Tensor:
    """The CUDA K2 pass in float32, from the plan's factor pair and f32
    tables: per line (b, j, k), input index a = n2 a1 + a2; stage 1 the
    length-n1 DFTs over a1 times tw[a2, c1]; stage 2 the length-n2 DFTs over
    a2, output index c = c1 + n1 c2; or the dense stage when n1 > 16."""
    b, n, j, k = x.shape
    lines = x.permute(0, 2, 3, 1).reshape(-1, n)
    w1, tw, w2 = (torch.as_tensor(t) for t in (plan.w1, plan.tw, plan.w2))
    if plan.n1 > 16:   # the dense stage: tw[0, c] sum_a x[a] w1[a c mod n]
        idx = torch.as_tensor(np.outer(np.arange(n), np.arange(n)) % n)
        y = (lines @ w1[idx]) * tw[0]
    else:
        z = lines.reshape(-1, plan.n1, plan.n2).transpose(1, 2)  # [a2, a1]
        z = _dft_line(z, w1) * tw                                 # [a2, c1]
        y = _dft_line(z.transpose(1, 2), w2)                      # [c1, c2]
        y = y.transpose(1, 2).reshape(-1, n)                      # c2 n1 + c1
    return y.reshape(b, j, k, n)


def _k2_emulation_error(rng, n, inverse):
    x = (rng.standard_normal((1, n, 2, 3))
         + 1j * rng.standard_normal((1, n, 2, 3))).astype(np.complex64)
    got = _k2_fft_emulated(torch.as_tensor(x), fft_plan(n, inverse))
    assert got.dtype == torch.complex64 and got.shape == (1, 2, 3, n)
    want = np.einsum("bajk,ac->bjkc", x.astype(np.complex128),
                     dft_matrix_np(n, inverse))
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [7, 12, 16, 32, 50, 60, 75, 100, 120, 150])
def test_k2_fft_plan_matches_einsum(rng, n, inverse):
    """The plan's index maps, twiddles and 1/N scale, run through the
    kernel's stages in float32, against the complex128 DFT: 5e-6 of the
    output scale (the card tests' tolerance)."""
    plan = fft_plan(n, inverse)
    assert plan.n1 * plan.n2 == n and plan.n1 <= plan.n2 <= 16
    assert plan.w1.dtype == plan.tw.dtype == plan.w2.dtype == np.complex64
    assert _k2_emulation_error(rng, n, inverse) <= 5e-6


@pytest.mark.parametrize("inverse", [False, True])
def test_k2_dense_stage_matches_einsum(rng, inverse):
    """34 = 2 x 17 has no pair of factors <= 16: one dense stage."""
    assert factor_pair(34) == (34, 1)
    assert _k2_emulation_error(rng, 34, inverse) <= 5e-6


def test_k2_fft_plan_factor_pairs():
    """The divisor pair nearest sqrt(N) with both factors <= 16, for the
    grids of the main path, pack_cmp, phase 12 and the coarse starts."""
    want = {8: (2, 4), 16: (4, 4), 32: (4, 8), 50: (5, 10), 60: (6, 10),
            75: (5, 15), 100: (10, 10), 120: (10, 12), 150: (10, 15),
            7: (1, 7), 256: (16, 16)}
    assert {n: factor_pair(n) for n in want} == want
    # f32 operations per output: far under the bytes bound at N=120
    assert 40.0 < plan_flops(120) < 50.0
