"""The port's inverse-dielectric operators against the JAX package's, in
float64 / complex128 on the same numpy inputs: each dielectric built by the
JAX package and carried across with ``interop.dielectric_from``, and built
natively by the port from the same (n, lattice, eps_opt), against
``DielectricOp.apply`` and against the pair form ``rs.diel_apply_p``; the
volume mask, the SDD accessors, Hermitian positive definiteness, and the
cross-DoF stencil against the reference's dense Kronecker assembly."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from pcx import config as jcfg
from pcx import geometry as jgeo
from pcx.operators import dielectric as jdiel
from pcx.operators import rs
from pcx_torch import geometry as tgeo
from pcx_torch import interop, stencils
from pcx_torch.config import (CHIRAL_EPS_EG, PSEUDOCHIRAL_EPS_LOC,
                              TYPE_CHIRAL, TYPE_PSEUDO_CROSSDOF,
                              TYPE_PSEUDO_TRIVIAL)
from pcx_torch.operators import dielectric as tdiel

# Every parallel test worker imports this file.  The problems here are
# small, so two intra-op threads per process do; the default (one per core
# in each worker) oversubscribes the cores several times over.
torch.set_num_threads(min(torch.get_num_threads(), 2))

# The same elementwise products and roll sums in the same order on both
# sides; only the grouping of the 0.5 and eps factors differs.
APPLY_RTOL = 1e-13
LATTICE = "sc_curv"


def _block(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_applies(jop, x):
    """x through DielectricOp.apply and through the pair form."""
    full = np.asarray(jop.apply(jnp.asarray(x)))
    re, im = rs.diel_apply_p(jop, (jnp.asarray(x.real), jnp.asarray(x.imag)))
    return full, np.asarray(re) + 1j * np.asarray(im)


def _carried(jop):
    return interop.dielectric_from(jop.name,
                                   [np.asarray(p) for p in jop.params],
                                   jop.meta, "cpu")


def _check_apply(jop, top, n, seed):
    x = _block(np.random.default_rng(seed), 2, 3, n, n, n)
    want, want_p = _jax_applies(jop, x)
    for op in (top, _carried(jop)):
        assert op.name == jop.name
        got = op(torch.as_tensor(x))
        assert got.dtype == torch.complex128
        assert _rel(got.numpy(), want) <= APPLY_RTOL
        assert _rel(got.numpy(), want_p) <= APPLY_RTOL
        # the complex64 iterate stays complex64 (no promotion by the eps
        # scalars or the held arrays) and agrees to float32 rounding
        got32 = op(torch.as_tensor(x).to(torch.complex64))
        assert got32.dtype == torch.complex64
        assert _rel(got32.numpy(), want) <= 1e-6


PSEUDO_CASES = ([(TYPE_PSEUDO_TRIVIAL, e, 1, 8) for e in range(4)]
                + [(TYPE_PSEUDO_CROSSDOF, e, k, n) for e in range(4)
                   for k, n in ((1, 8), (2, 12))])


@pytest.mark.parametrize("diel_type,eps_opt,k,n", PSEUDO_CASES)
def test_pseudochiral_apply_matches_pcx(diel_type, eps_opt, k, n):
    jop = jdiel.build(diel_type, n, LATTICE, eps_opt=eps_opt, k=k)
    top = tdiel.build(diel_type, n, LATTICE, "cpu", eps_opt=eps_opt, k=k)
    _check_apply(jop, top, n, seed=10 * eps_opt + k)


@pytest.mark.parametrize("kind", ["scalar_field", "smooth_eps", "identity",
                                  "chiral", "chiral_eps"])
def test_scalar_dielectric_apply_matches_pcx(kind):
    n = 8
    if kind == "scalar_field":
        inv = np.random.default_rng(5).uniform(0.05, 1.0, (n, n, n))
        jop, top = jdiel.scalar_field_op(inv), tdiel.scalar_field_op(inv,
                                                                     "cpu")
    elif kind == "smooth_eps":
        jop, top = jdiel.smooth_eps_op(n), tdiel.smooth_eps_op(n, "cpu")
        np.testing.assert_array_equal(top.scale64.numpy(),
                                      np.asarray(jop.params[0]))
    elif kind == "identity":
        jop, top = jdiel.build(None, n, None), tdiel.build("identity", n,
                                                           None, "cpu")
    else:
        eps_opt = 7 if kind == "chiral_eps" else 0   # for chiral: eps itself
        jop = jdiel.build(TYPE_CHIRAL, n, "fcc", eps_opt=eps_opt)
        top = tdiel.build(TYPE_CHIRAL, n, "fcc", "cpu", eps_opt=eps_opt)
        assert float(top.scale64.min()) == 1.0 / (eps_opt or
                                                  CHIRAL_EPS_EG["fcc"])
    _check_apply(jop, top, n, seed=6)
    with pytest.raises(NotImplementedError, match="no SDD accessors"):
        top.sdd_violations()


@pytest.mark.parametrize("n", [8, 11])
@pytest.mark.parametrize("lattice", jcfg.ALL_LATTICES)
def test_volume_mask_matches_pcx(lattice, n):
    want = jgeo.volume_mask(n, lattice, cache=False, use_native=False)
    got = tgeo.volume_mask(n, lattice, cache=False)
    assert got.dtype == bool and got.shape == (n, n, n)
    assert got.flags.writeable
    np.testing.assert_array_equal(got, want)


def test_random_fake_masks_match_pcx():
    """lattice=None: the reference's random fakes, from the same seeds."""
    np.testing.assert_array_equal(tgeo.volume_mask(6, None),
                                  jgeo.volume_mask(6, None))
    np.testing.assert_array_equal(tgeo.edge_mask(6, None),
                                  jgeo.edge_mask(6, None))
    rng = lambda: np.random.default_rng(9)
    np.testing.assert_array_equal(tgeo.volume_mask(6, None, rng=rng()),
                                  jgeo.volume_mask(6, None, rng=rng()))


@pytest.mark.parametrize("diel_type,eps_opt,k", [
    (TYPE_PSEUDO_TRIVIAL, 0, 1), (TYPE_PSEUDO_TRIVIAL, 2, 1),
    (TYPE_PSEUDO_TRIVIAL, 3, 1), (TYPE_PSEUDO_CROSSDOF, 0, 1),
    (TYPE_PSEUDO_CROSSDOF, 2, 1), (TYPE_PSEUDO_CROSSDOF, 3, 2)])
def test_sdd_accessors_match_pcx(diel_type, eps_opt, k):
    n = 10
    jop = jdiel.build(diel_type, n, LATTICE, eps_opt=eps_opt, k=k)
    for top in (tdiel.build(diel_type, n, LATTICE, "cpu", eps_opt=eps_opt,
                            k=k), _carried(jop)):
        assert top.diag().dtype == torch.float64
        np.testing.assert_array_equal(top.diag().numpy(),
                                      np.asarray(jop.diag()))
        np.testing.assert_allclose(top.offdiag_abs_row_sums().numpy(),
                                   np.asarray(jop.offdiag_abs_row_sums()),
                                   rtol=1e-14, atol=1e-16)
        assert top.sdd_violations() == jop.sdd_violations()


def _dense(op, n):
    """(3n^3, 3n^3) dense matrix of an operator on (p, 3, n, n, n) blocks."""
    d = 3 * n ** 3
    eye = torch.eye(d, dtype=torch.complex128).reshape(d, 3, n, n, n)
    return op(eye).reshape(d, d).T.numpy()


@pytest.mark.parametrize("eps_opt", [0, 2, 3])
@pytest.mark.parametrize("diel_type", [TYPE_PSEUDO_TRIVIAL,
                                       TYPE_PSEUDO_CROSSDOF])
def test_dielectric_hermitian_pd(diel_type, eps_opt):
    """The assembled eps^{-1} is Hermitian positive definite (reference:
    check_component_HPD, paper_2_test.py:283-297)."""
    n = 6
    d = _dense(tdiel.build(diel_type, n, LATTICE, "cpu", eps_opt=eps_opt), n)
    assert np.abs(d - d.conj().T).max() < 1e-12
    assert np.linalg.eigvalsh((d + d.conj().T) / 2).min() > 0


@pytest.mark.parametrize("eps_opt,k,n,lattice", [(0, 1, 4, "sc_curv"),
                                                 (2, 1, 5, "fcc"),
                                                 (3, 2, 5, "sc_flat2")])
def test_crossdof_matches_dense_kron_construction(eps_opt, k, n, lattice):
    """The roll-based cross-DoF operator against an explicit assembly that
    follows the reference's kron / restriction algebra
    (paper_2/discretization.py:403-453), built here with numpy and scipy
    only.  A Hermitian operator that couples the wrong neighbour passes the
    Hermitian test and fails this one."""
    eps_loc = PSEUDOCHIRAL_EPS_LOC[eps_opt] / CHIRAL_EPS_EG[lattice]
    mask = tgeo.edge_mask(n, lattice)
    nn = n ** 3
    # reference flat index i + j*n + k*n^2 (i fastest)
    flat = [mask[c].transpose(2, 1, 0).reshape(-1) for c in range(3)]
    sten = stencils.mfd_stencil(k, 0)
    c_mat = np.zeros((n, n))
    for j in range(2 * k):
        for r in range(n):
            c_mat[r, (r + j - (k - 1)) % n] += sten[j]
    eye = np.eye(n)
    kron3 = lambda a, b, c: sp.kron(sp.kron(a, b), c).toarray()
    # kron convention: the slowest flat index (k) is the OUTER factor
    t = {(0, 1): kron3(c_mat, c_mat.T, eye), (0, 2): kron3(c_mat, eye,
                                                          c_mat.T),
         (1, 2): kron3(eye, c_mat, c_mat.T)}
    dense = np.zeros((3 * nn, 3 * nn), dtype=complex)
    for c in range(3):
        blk = slice(c * nn, (c + 1) * nn)
        dense[blk, blk] = np.diag(np.where(flat[c], eps_loc[c].real, 1.0))
    for (a, b), e in zip(((0, 1), (0, 2), (1, 2)), eps_loc[3:]):
        m_ab = (np.diag(flat[a].astype(float)) @ t[a, b]
                + t[a, b] @ np.diag(flat[b].astype(float))) / 2
        ra, rb = slice(a * nn, (a + 1) * nn), slice(b * nn, (b + 1) * nn)
        dense[ra, rb] += e * m_ab
        dense[rb, ra] += np.conj(e) * m_ab.T

    op = tdiel.pseudochiral_crossdof_op(n, lattice, "cpu", eps_opt=eps_opt,
                                        k=k, edge_mask=mask)
    got = _dense(op, n)
    # got is (c, i, j, k) flattened C-order; dense is (c, k, j, i)
    perm = np.arange(3 * nn).reshape(3, n, n, n).transpose(0, 3, 2,
                                                           1).reshape(-1)
    np.testing.assert_allclose(got[np.ix_(perm, perm)], dense, atol=1e-12)


def test_crossdof_roll_fn_hook_replaces_the_roll():
    """``roll_fn(x, shift, axis)`` stands in for torch.roll (a grid-sharded
    path passes a halo-exchange roll): a roll made of slices gives the same
    operator, and every non-zero shift goes through the hook."""
    n, calls = 8, []

    def sliced_roll(x, shift, axis):
        calls.append((shift, axis))
        s = shift % x.shape[axis]
        return torch.cat((x.narrow(axis, x.shape[axis] - s, s),
                          x.narrow(axis, 0, x.shape[axis] - s)), dim=axis)

    x = torch.as_tensor(_block(np.random.default_rng(2), 3, n, n, n))
    want = tdiel.pseudochiral_crossdof_op(n, LATTICE, "cpu", eps_opt=3,
                                          k=2)(x)
    got = tdiel.pseudochiral_crossdof_op(n, LATTICE, "cpu", eps_opt=3, k=2,
                                         roll_fn=sliced_roll)(x)
    assert torch.equal(got, want)
    # 3 pairs x 2 sides x 2 T applies x 2 axes x 3 non-zero shifts of 4 taps
    assert len(calls) == 72 and all(s for s, _ in calls)
    assert {a for _, a in calls} == {-3, -2, -1}


def test_crossdof_skips_pairs_with_a_zero_eps_entry():
    """Preset 0 has d13 = d23 = 0: only the 12 pair is applied (8 rolls at
    k=1), and the result equals the JAX apply, which multiplies by zero."""
    n, calls = 8, []

    def counted(x, shift, axis):
        calls.append(axis)
        return torch.roll(x, shift, axis)

    op = tdiel.pseudochiral_crossdof_op(n, LATTICE, "cpu", eps_opt=0,
                                        roll_fn=counted)
    x = _block(np.random.default_rng(3), 3, n, n, n)
    got = op(torch.as_tensor(x)).numpy()
    assert len(calls) == 8 and set(calls) == {-1, -2}
    want = jdiel.build(TYPE_PSEUDO_CROSSDOF, n, LATTICE).apply(jnp.asarray(x))
    assert _rel(got, want) <= APPLY_RTOL


def test_build_and_interop_reject_unknown_names():
    with pytest.raises(KeyError, match="Unknown dielectric type 'nope'"):
        tdiel.build("nope", 8, LATTICE, "cpu")
    with pytest.raises(KeyError, match="no port operator"):
        interop.dielectric_from("nope", (), (), "cpu")
    assert sorted(tdiel.DIELECTRIC_REGISTRY) == sorted(
        jdiel.DIELECTRIC_REGISTRY)
    for got, want in zip(PSEUDOCHIRAL_EPS_LOC, jcfg.PSEUDOCHIRAL_EPS_LOC):
        np.testing.assert_array_equal(got, want)


def test_interop_takes_pair_form_sdiag_and_holds_both_precisions():
    """A complex off-diagonal may come as a (re, im) pair (the JAX solver's
    real-boundary encoding); the arrays are held in double and in single
    precision, the double copy exact."""
    n = 6
    jop = jdiel.build(TYPE_PSEUDO_TRIVIAL, n, LATTICE, eps_opt=3)
    diag, sdiag = (np.asarray(p) for p in jop.params)
    op = interop.dielectric_from(jop.name, (diag, (sdiag.real, sdiag.imag)),
                                 (), "cpu")
    assert op.diag64.dtype == torch.float64
    assert op.diag32.dtype == torch.float32
    assert op.sdiag64.dtype == torch.complex128
    assert op.sdiag32.dtype == torch.complex64
    np.testing.assert_array_equal(op.sdiag64.numpy(), sdiag)
    np.testing.assert_array_equal(op.diag32.numpy(),
                                  diag.astype(np.float32))
