"""The port's Fourier-space operator against the JAX package's pair
operator (``pcx.operators.rs``) on the same numpy inputs, in complex128 /
float64, plus the operator's Hermitian / PD / exact-inverse properties
(the port of tests/test_operator.py's checks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import lattices as jlat
from pcx import stencils as jst
from pcx.operators import dft as jdft
from pcx.operators import dielectric as jdiel
from pcx.operators import rs
from pcx_torch import interop
from pcx_torch.config import set_relaxation
from pcx_torch.operators import maxwell as tmax
from pcx_torch.operators import symbols as tsym
from pcx_torch.operators.blocks import a_block, h_block
from pcx_torch.operators.dft import dft_mats
from pcx_torch.operators import dielectric as tdiel
from pcx_torch.operators.dielectric import chiral_op, identity_op

# Symbols are closed-form elementwise products of the same 1-D parts:
# agreement to a few ulp (1e-13 relative).  The operator chains three
# block multiplies around two 3-D DFTs whose summation order differs
# (torch.fft / einsum vs XLA dot_generals): 1e-12 relative.
SYM_RTOL = 1e-13
OP_RTOL = 1e-12


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(a):
    a = np.asarray(a)
    return (jnp.asarray(a.real), jnp.asarray(a.imag))


def _cplx(p):
    return np.asarray(p[0]) + 1j * np.asarray(p[1])


def _parts(n, lattice):
    d1 = jst.symbol_1d(n, 1, 1, 1.0 / n)
    d0 = jst.symbol_1d(n, 1, 0)
    return d1, d0, jlat.ct_matrix(lattice)


def _jax_symbols(n, lattice, alpha):
    d1, d0, ct = _parts(n, lattice)
    (shift, _), pnt = set_relaxation(alpha)
    d_a = rs.build_curl_p(_pair(d1), _pair(d0), jnp.asarray(ct),
                          jnp.asarray(alpha))
    return d_a, rs.penalty_p(d_a, pnt), rs.inverse_penalized_p(d_a, pnt,
                                                               shift)


def _alpha(seed):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, 3)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("lattice", ["sc_curv", "fcc"])
def test_symbols_match_rs_constructors(lattice, n, seed):
    alpha = _alpha(seed)
    (shift, _), pnt = set_relaxation(alpha)
    parts = interop.symbol_parts(*_parts(n, lattice), device="cpu")
    d_a = tsym.build_curl(parts, alpha)
    b = tsym.penalty(d_a, pnt)
    inv = tsym.inverse_penalized(d_a, pnt, shift)
    jd_a, (jb_d, jb_s), (ji_d, ji_s) = _jax_symbols(n, lattice, alpha)
    assert d_a.dtype == torch.complex128 and b.diag.dtype == torch.float64
    assert _rel(d_a.numpy(), _cplx(jd_a)) <= SYM_RTOL
    assert _rel(b.diag.numpy(), jb_d) <= SYM_RTOL
    assert _rel(b.sdiag.numpy(), _cplx(jb_s)) <= SYM_RTOL
    assert _rel(inv.diag.numpy(), ji_d) <= SYM_RTOL
    assert _rel(inv.sdiag.numpy(), _cplx(ji_s)) <= SYM_RTOL


def _block(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("use_dft_mats", [False, True])
@pytest.mark.parametrize("lattice", ["sc_curv", "fcc"])
def test_ama_bb_matches_rs(lattice, use_dft_mats):
    n = 8
    rng = np.random.default_rng(3)
    alpha = _alpha(2)
    (shift, _), pnt = set_relaxation(alpha)
    x = _block(rng, (3, 3, n, n, n))
    jdiel_op = jdiel.chiral_op(n, lattice, dtype=np.float64)
    jd_a, (jb_d, jb_s), _ = _jax_symbols(n, lattice, alpha)
    w = jdft.dft_mats(n, np.complex128)
    want = _cplx(rs.ama_bb_p(_pair(x), jd_a, jb_d, jb_s, jdiel_op,
                             _pair(w.fwd), _pair(w.inv), shift=shift))

    parts = interop.symbol_parts(*_parts(n, lattice), device="cpu")
    d_a = tsym.build_curl(parts, alpha)
    b = tsym.penalty(d_a, pnt)
    diel = interop.dielectric(np.asarray(jdiel_op.params[0]), "cpu")
    mats = dft_mats(n, torch.complex128, "cpu") if use_dft_mats else None
    got = tmax.ama_bb(torch.as_tensor(x), d_a, b, diel, shift, mats)
    assert _rel(got.numpy(), want) <= OP_RTOL


@pytest.mark.parametrize("use_dft_mats", [False, True])
@pytest.mark.parametrize("diel_type,eps_opt", [
    ("pseudochiral_trivial", 0), ("pseudochiral_trivial", 3),
    ("pseudochiral_crossdof", 0), ("pseudochiral_crossdof", 2)])
def test_ama_bb_pseudochiral_matches_rs(diel_type, eps_opt, use_dft_mats):
    """The operator around a Hermitian-tensor dielectric, the JAX one
    carried across by name, against the pair operator (which applies it
    through ``rs.diel_apply_p``)."""
    n, lattice = 8, "sc_curv"
    rng = np.random.default_rng(7)
    alpha = _alpha(4)
    (shift, _), pnt = set_relaxation(alpha)
    x = _block(rng, (3, 3, n, n, n))
    jdiel_op = jdiel.build(diel_type, n, lattice, eps_opt=eps_opt)
    jd_a, (jb_d, jb_s), _ = _jax_symbols(n, lattice, alpha)
    w = jdft.dft_mats(n, np.complex128)
    want = _cplx(rs.ama_bb_p(_pair(x), jd_a, jb_d, jb_s, jdiel_op,
                             _pair(w.fwd), _pair(w.inv), shift=shift))

    parts = interop.symbol_parts(*_parts(n, lattice), device="cpu")
    d_a = tsym.build_curl(parts, alpha)
    b = tsym.penalty(d_a, pnt)
    mats = dft_mats(n, torch.complex128, "cpu") if use_dft_mats else None
    carried = interop.dielectric_from(
        jdiel_op.name, [np.asarray(p) for p in jdiel_op.params],
        jdiel_op.meta, "cpu")
    native = tdiel.build(diel_type, n, lattice, "cpu", eps_opt=eps_opt)
    for diel in (carried, native):
        got = tmax.ama_bb(torch.as_tensor(x), d_a, b, diel, shift, mats)
        assert _rel(got.numpy(), want) <= OP_RTOL


def test_h_block_matches_rs():
    n = 6
    rng = np.random.default_rng(4)
    x = _block(rng, (2, 3, n, n, n))
    diag = rng.standard_normal((3, n, n, n))
    sdiag = _block(rng, (3, n, n, n))
    want = _cplx(rs.h_block_p(_pair(x), jnp.asarray(diag), _pair(sdiag)))
    got = h_block(torch.as_tensor(x),
                  tsym.HermSymbol(torch.as_tensor(diag),
                                  torch.as_tensor(sdiag)))
    assert _rel(got.numpy(), want) <= OP_RTOL


def test_a_block_matches_rs():
    n = 6
    rng = np.random.default_rng(5)
    x = _block(rng, (2, 3, n, n, n))
    d = _block(rng, (3, n, n, n))
    want = _cplx(rs.a_block_p(_pair(x), _pair(d)))
    got = a_block(torch.as_tensor(x), torch.as_tensor(d))
    assert _rel(got.numpy(), want) <= OP_RTOL


N = 6
ALPHA = np.array([np.pi, 0.3, 0.1])


def _dense(op, n):
    """(3n^3, 3n^3) dense matrix of an operator on (p, 3, n, n, n)
    blocks."""
    d = 3 * n ** 3
    eye = torch.eye(d, dtype=torch.complex128).reshape(d, 3, n, n, n)
    return op(eye).reshape(d, d).T.numpy()


def _problem(diel):
    (shift, _), pnt = set_relaxation(ALPHA)
    parts = tsym.symbol_parts(N, 1, np.eye(3), 1.0, "cpu")
    d_a = tsym.build_curl(parts, ALPHA)
    return (d_a, tsym.penalty(d_a, pnt),
            tsym.inverse_penalized(d_a, pnt, shift), shift, diel)


def test_penalized_operator_hermitian_pd():
    d_a, b, _, shift, diel = _problem(chiral_op(N, "sc_curv", "cpu"))
    h = _dense(lambda v: tmax.ama_bb(v, d_a, b, diel, shift), N)
    assert np.abs(h - h.conj().T).max() < 1e-10
    assert np.linalg.eigvalsh((h + h.conj().T) / 2).min() > -1e-10


@pytest.mark.parametrize("diel_type", ["pseudochiral_trivial",
                                       "pseudochiral_crossdof"])
def test_penalized_operator_hermitian_pd_pseudochiral(diel_type):
    diel = tdiel.build(diel_type, N, "sc_curv", "cpu", eps_opt=3)
    d_a, b, _, shift, diel = _problem(diel)
    h = _dense(lambda v: tmax.ama_bb(v, d_a, b, diel, shift), N)
    assert np.abs(h - h.conj().T).max() < 1e-10
    assert np.linalg.eigvalsh((h + h.conj().T) / 2).min() > -1e-10


def test_ama_hermitian_psd_with_kernel():
    """A M A^H is Hermitian PSD with the N^3-dimensional divergence
    kernel that the penalty removes."""
    d_a, _, _, _, diel = _problem(chiral_op(N, "sc_curv", "cpu"))
    a = _dense(lambda v: tmax.ama(v, d_a, diel), N)
    assert np.abs(a - a.conj().T).max() < 1e-10
    w = np.linalg.eigvalsh((a + a.conj().T) / 2)
    assert w.min() > -1e-8
    assert int(np.sum(w < 1e-8)) == N ** 3


def test_preconditioner_is_exact_inverse():
    """P = (A A^H + pnt B^H B + shift)^{-1} exactly in vacuum (M = I)."""
    d_a, b, inv, shift, diel = _problem(identity_op())
    h = _dense(lambda v: tmax.ama_bb(v, d_a, b, diel, shift), N)
    p = _dense(lambda v: h_block(v, inv), N)
    np.testing.assert_allclose(p @ h, np.eye(3 * N ** 3), atol=1e-8)


def test_plane_wave_start_is_divergence_free_and_matches_pcx():
    """The plane-wave columns are transverse (D(f) . v = 0) and the same
    selection as the JAX package's."""
    from pcx.operators import maxwell as jmax
    n, m = 8, 16
    parts = tsym.symbol_parts(n, 1, np.eye(3), 1.0, "cpu")
    d_a = tsym.build_curl(parts, ALPHA).numpy()
    idx, amps = tmax.plane_wave_cols(d_a, m)
    jidx, jamps = jmax.plane_wave_cols(d_a, m)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(amps, jamps)
    d = d_a.reshape(3, -1)[:, idx].T
    assert np.abs(np.sum(d * amps, axis=1)).max() < 1e-12
    x0 = tmax.plane_wave_scatter(idx, amps, n, torch.complex128, "cpu")
    assert x0.shape == (m, 3, n, n, n)
    np.testing.assert_array_equal(
        x0.reshape(m, 3, -1)[np.arange(m), :, idx].numpy(), amps)
