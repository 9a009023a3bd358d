"""Kernels K1 (resid_precond), K2 (axis_dft / dft3) and K3 (gram9) of the
port.

On the CPU the wrappers take their plain PyTorch versions, which are held
against the JAX Pallas kernels run in interpret mode (as tests/test_pallas.py
runs them).  The CUDA kernels themselves are held against the plain versions
in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx.operators import dft as jdft
from pcx.operators.pallas_kernels import (dft3_pairs_fused, fused_gram9_pairs,
                                          fused_resid_precond)
from pcx_torch.kernels import axis_dft, gram9, resid_precond
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
    got = dft3(torch.as_tensor(x), getattr(mats, direction)).numpy()
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
    np.testing.assert_allclose(dft3(x, mats.fwd).numpy(), fwd.numpy(),
                               atol=1e-12 * float(fwd.abs().max()))
    np.testing.assert_allclose(dft3(fwd, mats.inv).numpy(), x.numpy(),
                               atol=1e-12 * float(x.abs().max()))


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
    axis_dft(torch.zeros((2, 4, 4, 4), dtype=torch.complex64),
             torch.eye(4, dtype=torch.complex64))
    gram9(*(torch.as_tensor(a) for a in _k3_blocks(rng, 2, 100)))
    assert (resid_precond.launches, axis_dft.launches,
            gram9.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    x, hx, lam, idg, isd = (torch.as_tensor(a)
                            for a in _k1_inputs(rng, 2, 64))
    with pytest.raises(ValueError, match="complex64"):
        axis_dft(torch.zeros((1, 4, 4, 4), dtype=torch.complex128),
                 torch.eye(4, dtype=torch.complex128))
    with pytest.raises(ValueError, match=r"\(B, A, J, K\)"):
        axis_dft(torch.zeros((4, 4, 4), dtype=torch.complex64),
                 torch.eye(4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="lam"):
        resid_precond(x, hx, lam.double(), idg, isd)
    with pytest.raises(ValueError, match="inv_sd"):
        resid_precond(x, hx, lam, idg, isd[:, :10])
    blocks = [torch.as_tensor(a) for a in _k3_blocks(rng, 2, 100)]
    with pytest.raises(ValueError, match="hw must be complex64"):
        gram9(*blocks[:4], blocks[4].to(torch.complex128), blocks[5])
    with pytest.raises(ValueError, match="p must be complex64"):
        gram9(blocks[0], blocks[1], blocks[2][:, :50], *blocks[3:])
