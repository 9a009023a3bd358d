"""The port's eigensolver library against the JAX package's on identical
numpy inputs: the Rayleigh-Ritz helpers (complex128, to 1e-12 of the
scale, masked helpers on their kept rows), and every library solver of
``pcx/solvers/`` on the dense problems of tests/test_lobpcg.py — complex128
eigenvalues to 1e-8 relative with iterations within 2 of the JAX solve from
the same start; the complex64 / float32 forms at their own bounds."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from pcx.solvers import davidson as jdav
from pcx.solvers import lobpcg as jlob
from pcx.solvers import lobpcg_rs as jlrs
from pcx.solvers import rayleigh_ritz as jrr
from pcx_torch.solvers import davidson as tdav
from pcx_torch.solvers import lobpcg as tlob
from pcx_torch.solvers import lobpcg_rs as tlrs
from pcx_torch.solvers import rayleigh_ritz as trr

# Every parallel test worker imports this file: two intra-op threads each.
torch.set_num_threads(min(torch.get_num_threads(), 2))

ALG_TOL = 1e-12
EIG_RTOL = 1e-8
ITER_SLACK = 2


def _random_hpd(n, rng, cond=50.0):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    d = np.geomspace(1.0, cond, n)
    return (q * d) @ q.conj().T


def _blk(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _hpd_small(rng, m, shift):
    a = _blk(rng, m, m)
    return a @ a.conj().T + shift * np.eye(m)


def _same_vectors(cj, ct, g, tol):
    """Pencil eigenvectors agree up to a phase each: the G-overlap of the
    two sets is a diagonal of unit-modulus entries."""
    ov = np.abs(np.asarray(cj).conj().T @ g @ np.asarray(ct))
    np.testing.assert_allclose(ov, np.eye(ov.shape[0]), atol=tol)


# ---------------------------------------------------------------- helpers --

def _helper_case(name, rng):
    """(jax result, torch result, comparison) of one helper on seeded
    complex128 inputs."""
    t_ = torch.as_tensor
    if name == "short_qr":
        x = _blk(rng, 6, 200)
        return np.asarray(jrr.short_qr(jnp.asarray(x))), \
            trr.short_qr(t_(x)).numpy()
    if name in ("eigh_pencil", "eigh_pencil_whiten"):
        t, g = _hpd_small(rng, 12, 1.0), _hpd_small(rng, 12, 10.0)
        th_j, c_j = getattr(jrr, name)(jnp.asarray(t), jnp.asarray(g))
        th_t, c_t = getattr(trr, name)(t_(t), t_(g))
        _same_vectors(c_j, c_t.numpy(), g, 1e-9)
        want = sla.eigh(t, g)[0]   # the whitened form keeps its split
        np.testing.assert_allclose(th_t.numpy(), want,
                                   atol=1e-9 * np.abs(want).max())
        return np.asarray(th_j), th_t.numpy()
    if name == "rayleigh_ritz":
        a = _random_hpd(300, rng)
        s = _blk(rng, 5, 300)
        th_j, _ = jrr.rayleigh_ritz(jnp.asarray(s), jnp.asarray(s @ a.T))
        th_t, _ = trr.rayleigh_ritz(t_(s), t_(s @ a.T))
        return np.asarray(th_j), th_t.numpy()
    if name == "masked_loewdin":
        b, hb = _blk(rng, 6, 300), _blk(rng, 6, 300)
        mask = np.array([1, 1, 0, 1, 1, 1.0])
        b[2] = hb[2] = 0.0
        qj, hqj = jrr.masked_loewdin(jnp.asarray(b), jnp.asarray(mask), 1e-14,
                                     hblock=jnp.asarray(hb), passes=2)
        qt, hqt = trr.masked_loewdin(t_(b), t_(mask), 1e-14, hblock=t_(hb),
                                     passes=2)
        keep = mask > 0
        return (np.concatenate([np.asarray(qj)[keep], np.asarray(hqj)[keep]]),
                np.concatenate([qt.numpy()[keep], hqt.numpy()[keep]]))
    if name in ("masked_mgs", "masked_cholqr"):
        b, hb = _blk(rng, 6, 300), _blk(rng, 6, 300)
        b[4] = b[0] + 2j * b[1]        # dependent: MGS drops it
        mask = np.array([1, 1, 1, 0, 1, 1.0])
        b[3] = hb[3] = 0.0
        if name == "masked_cholqr":
            b[4] += 0.3 * _blk(rng, 300)
            qj, hqj = jrr.masked_cholqr(jnp.asarray(b), jnp.asarray(mask),
                                        1e-14, hblock=jnp.asarray(hb),
                                        passes=2)
            qt, hqt = trr.masked_cholqr(t_(b), t_(mask), 1e-14, hblock=t_(hb),
                                        passes=2)
            keep = mask > 0
        else:
            base = np.linalg.qr(_blk(rng, 300, 2))[0].T.copy()
            hbase = _blk(rng, 2, 300)
            qj, hqj, kj = jrr.masked_mgs(
                jnp.asarray(b), jnp.asarray(mask), 1e-6,
                hblock=jnp.asarray(hb), against=(jnp.asarray(base),),
                h_against=(jnp.asarray(hbase),))
            qt, hqt, kt = trr.masked_mgs(
                t_(b), t_(mask), 1e-6, hblock=t_(hb), against=(t_(base),),
                h_against=(t_(hbase),))
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            assert kt.numpy().tolist() == [1, 1, 1, 0, 0, 1]
            keep = kt.numpy() > 0
        q = qt.numpy()[keep]
        np.testing.assert_allclose(q.conj() @ q.T, np.eye(int(keep.sum())),
                                   atol=1e-12)
        return (np.concatenate([np.asarray(qj)[keep], np.asarray(hqj)[keep]]),
                np.concatenate([q, hqt.numpy()[keep]]))
    if name == "project_off":
        b, hb = _blk(rng, 4, 300), _blk(rng, 4, 300)
        base = np.linalg.qr(_blk(rng, 300, 3))[0].T.copy()
        hbase = _blk(rng, 3, 300)
        bj, hj = jrr.project_off(jnp.asarray(b), jnp.asarray(base),
                                 jnp.asarray(hb), jnp.asarray(hbase))
        bt, ht = trr.project_off(t_(b), t_(base), t_(hb), t_(hbase))
        return (np.concatenate([np.asarray(bj), np.asarray(hj)]),
                np.concatenate([bt.numpy(), ht.numpy()]))
    if name == "power_method":
        a = _random_hpd(80, rng, cond=5.0)
        a = a + 10.0 * np.outer(a[0], a[0].conj()) / np.vdot(a[0], a[0])
        x0 = _blk(rng, 80)
        aj, at = jnp.asarray(a), t_(a)
        lj, xj, ij = jrr.power_method(lambda v: aj @ v, jnp.asarray(x0),
                                      tol=1e-10)
        lt, xt, it = trr.power_method(lambda v: at @ v, t_(x0), tol=1e-10)
        assert it == int(ij) < 1000
        np.testing.assert_allclose(float(lt), np.linalg.eigvalsh(a)[-1],
                                   rtol=1e-9)
        return (np.concatenate([[float(lj)], np.asarray(xj)]),
                np.concatenate([[float(lt)], xt.numpy()]))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "short_qr", "eigh_pencil", "eigh_pencil_whiten", "rayleigh_ritz",
    "masked_loewdin", "masked_mgs", "masked_cholqr", "project_off",
    "power_method"])
def test_rayleigh_ritz_helper_matches_pcx(rng, name):
    want, got = _helper_case(name, rng)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ALG_TOL * np.abs(want).max())


def test_eigh_pencil_whiten_dead_convention(rng):
    """Masked pencil rows (G_ii = 1, T_ii = -dead_val) sort first at
    -dead_val, the rest is the kept pencil (tests/test_lobpcg.py::
    test_eigh_pencil_whiten_matches_scipy)."""
    m = 12
    t, g = _hpd_small(rng, m, 1.0), _hpd_small(rng, m, 10.0)
    mask = np.ones(m)
    mask[-3:] = 0
    keep = np.outer(mask, mask)
    dead_val = np.linalg.norm(t) + 1
    tm = t * keep - dead_val * np.diag(1 - mask)
    gm = g * keep + np.diag(1 - mask)
    th, _ = trr.eigh_pencil_whiten(torch.as_tensor(tm), torch.as_tensor(gm))
    th_j, _ = jrr.eigh_pencil_whiten(jnp.asarray(tm), jnp.asarray(gm))
    th = np.sort(th.numpy())
    np.testing.assert_allclose(th[:3], -dead_val, atol=1e-6)
    np.testing.assert_allclose(th[3:], sla.eigh(t[:9, :9], g[:9, :9])[0],
                               atol=1e-6)
    np.testing.assert_allclose(th, np.sort(np.asarray(th_j)),
                               atol=ALG_TOL * dead_val)


# ----------------------------------------------------------- the solvers --

def _apply(a, side):
    """Row-block operator b -> b a^T on either side."""
    if side == "jax":
        aj = jnp.asarray(a)
        return lambda b: b @ aj.T
    at = torch.as_tensor(a).T
    return lambda b: b @ at


def _arr(x, side):
    return jnp.asarray(x) if side == "jax" else torch.as_tensor(x)


def _pair(z):
    return (jnp.asarray(z.real), jnp.asarray(z.imag))


def _pair_op(mat, side):
    """The operator of the pair tests of tests/test_lobpcg.py, y = v
    conj(M)^T: on (re, im) pairs for the JAX twins, complex for the port."""
    if side == "torch":
        return _apply(mat.conj(), "torch")
    mr, mi = jnp.asarray(mat.real), jnp.asarray(mat.imag)
    return lambda v: (v[0] @ mr.T + v[1] @ mi.T, v[1] @ mr.T - v[0] @ mi.T)


def _sep_problem(rng, n, nev, extra, cond=50.0):
    a = _random_hpd(n, rng, cond)
    return a, _blk(rng, nev + extra, n)


def _gep_problem(rng, n=40, m=8):
    a = _random_hpd(n, rng)
    b = _random_hpd(n, rng) + 9.0 * np.eye(n)
    return a, b, _blk(rng, m, n)


def _run_case(name, rng):
    """Run one library solve on both sides; returns (results by side, nev,
    exact eigenvalues, rtol against them, which end of the spectrum)."""
    out = {}
    ident = lambda v: v    # noqa: E731
    low = "min"
    if name in ("softlock", "nolock", "mgs", "mixedprecision", "rr_f64"):
        n, nev = 100, 5
        a, x0 = _sep_problem(rng, n, nev, 4)
        want, rtol = np.linalg.eigvalsh(a)[:nev], 1e-6
        fn = {"softlock": "lobpcg_sep_softlock", "nolock": "lobpcg_sep_nolock",
              "mixedprecision": "lobpcg_sep_mixedprecision"}.get(
                  name, "lobpcg_sep")
        kw = {"mgs": {"ortho": "mgs", "shift": 2.5},
              "rr_f64": {"rr_mode": "f64", "rr_mirror": True}}.get(name, {})
        for side, mod in (("jax", jlob), ("torch", tlob)):
            out[side] = getattr(mod, fn)(_apply(a, side), ident,
                                         _arr(x0, side), nev, tol=1e-8,
                                         maxiter=300, **kw)
    elif name == "descent":
        nev = 3
        a, x0 = _sep_problem(rng, 80, nev, 3, cond=20.0)
        want, rtol = np.linalg.eigvalsh(a)[:nev], 1e-5
        for side, mod in (("jax", jlob), ("torch", tlob)):
            out[side] = mod.descent_sep(_apply(a, side), ident,
                                        _arr(x0, side), nev, tol=1e-7,
                                        maxiter=500)
    elif name in ("default_min", "default_max"):
        n, nev, tol = {"default_min": (120, 6, 1e-8),
                       "default_max": (80, 3, 1e-7)}[name]
        a = _random_hpd(n, rng)
        low = "max" if name == "default_max" else "min"
        ev = np.linalg.eigvalsh(a)
        want = ev[::-1][:nev] if low == "max" else ev[:nev]
        rtol = 1e-4 if low == "max" else 1e-6
        for side, mod in (("jax", jlob), ("torch", tlob)):
            kw = {} if side == "jax" else {"device": "cpu"}
            out[side] = mod.lobpcg_default(_arr(a, side), nev=nev, rlx=4,
                                           maxmin=low, tol=tol, maxiter=300,
                                           **kw)
    elif name in ("gep_chol", "gep_embedding", "gep_whiten", "descent_gep",
                  "gep_rs", "descent_gep_rs"):
        # tests/test_lobpcg.py::test_gep_dense; the slow forms (the
        # whitened pencil's split, descent) to the looser tolerance of
        # test_gep_embedding_pencil_matches_chol: without orthonormalization
        # the GEP basis turns ill-conditioned and rounding differences grow,
        # so the two packages part ways in the last digits of long runs
        nev = 4
        a, b = _random_hpd(90, rng), _random_hpd(90, rng, cond=50)
        x0 = _blk(rng, nev + 4, 90)
        want, rtol = sla.eigh(a, b, eigvals_only=True)[:nev], 1e-5
        kw = {"gep_chol": {"rr_pencil": "chol"},
              "gep_embedding": {"rr_pencil": "embedding"},
              "gep_whiten": {"rr_pencil": "whiten"}}.get(name, {})
        tol = {"gep_whiten": 1e-5, "descent_gep": 1e-4,
               "descent_gep_rs": 1e-4}.get(name, 1e-7)
        fn = {"descent_gep": "descent_gep", "gep_rs": "lobpcg_gep_rs",
              "descent_gep_rs": "descent_gep_rs"}.get(name, "lobpcg_gep")
        for side in ("jax", "torch"):
            mod = ((jlrs if side == "jax" else tlrs) if name.endswith("_rs")
                   else (jlob if side == "jax" else tlob))
            if name.endswith("_rs"):
                ops = (_pair_op(a, side), _pair_op(b, side))
                start = _pair(x0) if side == "jax" else _arr(x0, side)
            else:
                ops = (_apply(a, side), _apply(b, side))
                start = _arr(x0, side)
            out[side] = getattr(mod, fn)(*ops, ident, start, nev, tol=tol,
                                         maxiter=500, **kw)
    elif name == "sep_max":
        n, nev = 70, 3
        a, x0 = _sep_problem(rng, n, nev, 4)
        low = "max"
        want, rtol = np.linalg.eigvalsh(a)[::-1][:nev], 1e-4
        for side, mod in (("jax", jlob), ("torch", tlob)):
            out[side] = mod.lobpcg_sep_max(_apply(a, side), _arr(x0, side),
                                           nev, tol=1e-7, maxiter=600,
                                           rr_pencil="embedding")
    elif name == "svd_min":
        # tests/test_lobpcg.py::test_lobpcg_svd_smallest at tol 1e-7: the
        # normal operator squares the condition, and near 1e-9 the two
        # packages' rounding parts the residual histories
        n, nev = 60, 3
        a = _blk(rng, n, n) + 3 * np.eye(n)
        x0 = _blk(rng, 6, n)
        want, rtol = np.sort(np.linalg.svd(a, compute_uv=False))[:nev], 1e-4
        for side, mod in (("jax", jlob), ("torch", tlob)):
            at = _apply(a.conj().T, side)
            out[side] = mod.lobpcg_svd(_apply(a, side), at, _arr(x0, side),
                                       nev, tol=1e-7, maxiter=400)
    elif name in ("davidson", "jd"):
        n, nev = 100, (4 if name == "davidson" else 3)
        a, x0 = _sep_problem(rng, n, nev, 2, cond=30.0)
        want = np.linalg.eigvalsh(a)[:nev]
        rtol = 1e-3 if name == "davidson" else 1e-4
        kw = ({"tol": 1e-4, "maxiter": 200} if name == "davidson"
              else {"tol": 1e-5, "maxiter": 150, "inner_steps": 4})
        fn = "davidson_sep" if name == "davidson" else "jd_sep"
        for side, mod in (("jax", jdav), ("torch", tdav)):
            out[side] = getattr(mod, fn)(_apply(a, side), ident,
                                         _arr(x0, side), nev, subspace=30,
                                         **kw)
    elif name == "sep_max_rs":
        a, _, x0 = _gep_problem(rng)
        nev, low, x0 = 2, "max", x0[:6]
        want, rtol = np.linalg.eigvalsh(a)[::-1][:nev], 1e-5
        out["jax"] = jlrs.lobpcg_sep_max_rs(_pair_op(a, "jax"), _pair(x0),
                                            nev, tol=1e-8, maxiter=300)
        out["torch"] = tlrs.lobpcg_sep_max_rs(_pair_op(a, "torch"),
                                              torch.as_tensor(x0), nev,
                                              tol=1e-8, maxiter=300)
    else:
        raise KeyError(name)
    return out, nev, want, rtol, low


def _lams(res, nev, low):
    lam = np.asarray(res.lambdas, float)
    return (np.sort(lam)[::-1] if low == "max" else np.sort(lam))[:nev]


@pytest.mark.parametrize("name", [
    "softlock", "nolock", "mgs", "mixedprecision", "rr_f64", "descent",
    "default_min", "default_max", "gep_chol", "gep_embedding", "gep_whiten",
    "descent_gep", "sep_max", "svd_min", "davidson", "jd", "gep_rs",
    "descent_gep_rs", "sep_max_rs"])
def test_library_solver_matches_pcx(rng, name):
    out, nev, want, rtol, low = _run_case(name, rng)
    rj, rt = out["jax"], out["torch"]
    assert isinstance(rt.lambdas, torch.Tensor)
    assert rt.status == int(rj.status), (rt.status, int(rj.status))
    assert abs(rt.iterations - int(rj.iterations)) <= ITER_SLACK, \
        (rt.iterations, int(rj.iterations))
    got, ref = _lams(rt, nev, low), _lams(rj, nev, low)
    np.testing.assert_allclose(got, ref, rtol=EIG_RTOL)
    np.testing.assert_allclose(got, want, rtol=rtol)
    his = rt.res_history[~np.isnan(rt.res_history)]
    assert len(his) == rt.iterations + (rt.status != tlob.Status.MAXITER)


def _c64_op(mat):
    mt = torch.as_tensor(mat.conj().T, dtype=torch.complex64)
    return lambda v: v @ mt


@pytest.mark.parametrize("name,bound", [("lobpcg_gep_rs", 1e-3),
                                        ("lobpcg_sep_max_rs", 1e-3),
                                        ("descent_gep_rs", 5e-3)])
def test_single_precision_gep_family_at_its_bounds(rng, name, bound):
    """The float32 pair tests of tests/test_lobpcg.py in complex64, each
    at that test's relative bound: the FLOOR stop that returns the
    best-seen Ritz values (test_gep_rs_f32_floor_returns_best_lambdas),
    the largest-eigenvalue form (test_max_rs_matches_dense_spectrum) and
    descent (test_descent_gep_rs_converges)."""
    a, b, x0 = _gep_problem(rng)
    x0 = torch.as_tensor(x0, dtype=torch.complex64)
    if name == "lobpcg_sep_max_rs":
        nev, low = 2, "max"
        want = np.linalg.eigvalsh(a)[::-1][:nev]
        res = tlrs.lobpcg_sep_max_rs(_c64_op(a), x0[:6], nev, tol=1e-4,
                                     maxiter=300)
    else:
        nev, low = 4, "min"
        want = sla.eigh(a, b, eigvals_only=True)[:nev]
        kw = ({"tol": 1e-6} if name == "lobpcg_gep_rs"
              else {"tol": 1e-4, "floor_patience": 20})
        res = getattr(tlrs, name)(_c64_op(a), _c64_op(b), lambda v: v, x0,
                                  nev, maxiter=300, **kw)
    assert res.x.dtype == torch.complex64
    if name == "lobpcg_gep_rs":
        assert res.status in (tlob.Status.CONVERGED, tlob.Status.FLOOR)
    rel = np.abs(_lams(res, nev, low) - want) / np.abs(want)
    assert rel.max() < bound, rel


def test_single_precision_lobpcg_sep_converges(rng):
    """complex64 iterate through the complex128-accumulated Rayleigh-Ritz
    (tests/test_lobpcg.py::test_single_precision_converges, its bounds)."""
    n, nev = 150, 5
    a = _random_hpd(n, rng, cond=100.0).astype(np.complex64)
    want = np.linalg.eigvalsh(a.astype(np.complex128))[:nev]
    x0 = _blk(rng, nev + 4, n).astype(np.complex64)
    res = tlob.lobpcg_sep_softlock(_apply(a, "torch"), lambda v: v,
                                   torch.as_tensor(x0), nev, tol=1e-4,
                                   maxiter=500)
    assert res.x.dtype == torch.complex64
    np.testing.assert_allclose(res.lambdas[:nev].numpy(), want, rtol=1e-3,
                               atol=1e-3)


def test_lobpcg_default_takes_a_vector_function(rng):
    """``a`` as a (function, size) tuple (the function maps one vector)
    runs the solve of the dense matrix: the same start, the same
    iterations and eigenvalues."""
    a = _random_hpd(40, rng)
    at = torch.as_tensor(a)
    dense = tlob.lobpcg_default(at, nev=3, rlx=3, tol=1e-8, maxiter=200,
                                device="cpu")
    fn = tlob.lobpcg_default((lambda v: at @ v, 40), nev=3, rlx=3, tol=1e-8,
                             maxiter=200, device="cpu")
    assert fn.status == dense.status == tlob.Status.CONVERGED
    assert abs(fn.iterations - dense.iterations) <= ITER_SLACK
    np.testing.assert_allclose(fn.lambdas[:3].numpy(),
                               np.linalg.eigvalsh(a)[:3], rtol=1e-10)
    with pytest.raises(ValueError, match="maxmin"):
        tlob.lobpcg_default(at, nev=3, maxmin="mid", device="cpu")


def test_davidson_takes_a_pair_start(rng):
    """A (re, im) start, the JAX twins' layout, runs the same solve."""
    a, x0 = _sep_problem(rng, 60, 3, 2, cond=30.0)
    h = _apply(a, "torch")
    one = tdav.davidson_sep(h, lambda v: v, torch.as_tensor(x0), 3,
                            tol=1e-6, maxiter=100)
    two = tdav.davidson_sep(h, lambda v: v, (torch.as_tensor(x0.real),
                                             torch.as_tensor(x0.imag)), 3,
                            tol=1e-6, maxiter=100)
    assert one.status == two.status == tlob.Status.CONVERGED
    assert one.iterations == two.iterations
    assert torch.equal(one.lambdas, two.lambdas)
