"""The lockstep k-point batch of the complex LOBPCG family
(``lobpcg_sep_lanes``, its descent and mixed-precision forms, the lane
forms of ``rayleigh_ritz``'s helpers, ``KPointSolver(solver_impl=
"complex").solve_batch`` and ``bandgap(k_batch=)``) against the JAX
package's vmapped batch (``jax.vmap`` of ``pcx.solvers.lobpcg.lobpcg_sep``,
which ``_jitted_batch`` runs) and against the port's own serial solves, on
the CPU in complex128."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcx import boundary
from pcx.solvers import lobpcg as jlob
from pcx_torch import bandstructure as bs
from pcx_torch import interop
from pcx_torch.solvers import lobpcg as tlob
from pcx_torch.solvers import rayleigh_ritz as trr
from pcx_torch.solvers.lobpcg import Status

from test_torch_solver import _pair_solvers, _x0

torch.set_num_threads(min(torch.get_num_threads(), 2))

N_DIM, NEV, M = 100, 5, 9
# Three distinct evenly spaced spectra, one per lane, as in
# tests/test_torch_lanes.py (their norms near 10 keep the 1e-10 gate above
# the graded split of eigh_split).
SPECTRA = ((1.0, 10.0), (2.0, 12.0), (0.5, 8.0))
RITZ_TOL = 1e-10
OMEGA_TOL = 1e-7


def _hpd(rng, n, lo, hi):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return (q * np.linspace(lo, hi, n)) @ q.conj().T


def _problems(rng):
    """Three dense HPD operators, one start block per lane and a diagonal
    preconditioner of each operator."""
    mats = np.stack([_hpd(rng, N_DIM, *s) for s in SPECTRA])
    x0 = rng.normal(size=(3, M, N_DIM)) + 1j * rng.normal(size=(3, M, N_DIM))
    prec = 1.0 / np.abs(np.einsum("lii->li", mats))
    return mats, x0, prec


def _lane_funcs(mats, prec):
    """h_func and p_func of the lanes: operator and preconditioner of the
    lanes ``lanes`` on an (R, c, D) block."""
    ats = [torch.as_tensor(a) for a in mats]
    ps = [torch.as_tensor(p) for p in prec]

    def h(v, lanes):
        return torch.stack([v[i] @ ats[j].T for i, j in enumerate(lanes)])

    def p(v, lanes):
        return torch.stack([v[i] * ps[j].to(v.dtype)
                            for i, j in enumerate(lanes)])

    return h, p


def _assert_lane(got, status, iterations, lambdas, lane):
    assert got.status == status, lane
    assert abs(got.iterations - iterations) <= 1, (lane, got.iterations,
                                                   iterations)
    np.testing.assert_allclose(np.asarray(got.lambdas)[:NEV],
                               np.asarray(lambdas)[:NEV], rtol=0,
                               atol=RITZ_TOL)


@pytest.mark.parametrize("kw", [{"locking": True}, {"locking": False},
                                {"ortho": "mgs"}],
                         ids=["softlock", "nolock", "mgs"])
def test_lanes_match_jax_vmapped_batch(rng, kw):
    """(a) Three lanes of distinct operators through ``lobpcg_sep_lanes``
    against ``jax.vmap`` of the JAX ``lobpcg_sep`` over per-lane operators
    and starts, complex128: per lane the same status, iterations within
    one, the lowest NEV Ritz values within 1e-10."""
    mats, x0, prec = _problems(rng)
    kw = dict(tol=1e-8, maxiter=300, **kw)

    def one(a, p, x):
        return jlob.lobpcg_sep(lambda v: v @ a.T, lambda v: v * p, x, NEV,
                               **kw)

    rj = jax.vmap(one)(jnp.asarray(mats), jnp.asarray(prec), jnp.asarray(x0))
    h, p = _lane_funcs(mats, prec)
    got = tlob.lobpcg_sep_lanes(h, p, torch.as_tensor(x0), NEV, **kw)
    assert len(got) == 3
    for lane, r in enumerate(got):
        assert int(rj.status[lane]) == Status.CONVERGED
        _assert_lane(r, int(rj.status[lane]), int(rj.iterations[lane]),
                     rj.lambdas[lane], lane)


SERIAL = {
    "softlock": (tlob.lobpcg_sep_lanes, tlob.lobpcg_sep, {}),
    "nolock": (tlob.lobpcg_sep_lanes, tlob.lobpcg_sep_nolock,
               {"locking": False}),
    "descent": (tlob.lobpcg_sep_lanes, tlob.descent_sep, {"use_p": False}),
    "mixed": (tlob.lobpcg_sep_mixedprecision_lanes,
              tlob.lobpcg_sep_mixedprecision, {}),
}


@pytest.mark.parametrize("variant", list(SERIAL))
def test_lanes_match_serial_solves(rng, variant):
    """(b) Each lane against the port's serial solver of its variant from
    the same start, with the lane's own refresh period: the same status,
    iterations within one, Ritz values within 1e-10.  Lane 2's operator
    is scaled down, so it converges first and leaves the batch while the
    others run on."""
    mats, x0, prec = _problems(rng)
    mats[2] = mats[2] / 4.0
    prec[2] = prec[2] * 4.0
    lanes_fn, serial_fn, kw = SERIAL[variant]
    refresh = [5, 3, 8]
    tol = 1e-6 if variant == "descent" else 1e-8
    kw = dict(tol=tol, maxiter=400, **kw)
    h, p = _lane_funcs(mats, prec)
    got = lanes_fn(h, p, torch.as_tensor(x0), NEV, refresh_every=refresh,
                   **kw)
    its = [r.iterations for r in got]
    assert its[2] < min(its[:2]), its
    for lane, r in enumerate(got):
        at, pt = torch.as_tensor(mats[lane]), torch.as_tensor(prec[lane])
        s = serial_fn(lambda v: v @ at.T, lambda v: v * pt.to(v.dtype),
                      torch.as_tensor(x0[lane]), NEV,
                      refresh_every=refresh[lane], **kw)
        assert s.status == Status.CONVERGED, lane
        _assert_lane(r, s.status, s.iterations, s.lambdas, lane)


def _blk(rng, *s):
    return torch.as_tensor(rng.normal(size=s) + 1j * rng.normal(size=s))


def test_rayleigh_ritz_lane_forms_equal_2d_calls(rng):
    """(c) The lane forms of ``masked_loewdin``, ``rayleigh_ritz`` and
    ``masked_mgs``: lane i of each equals the 2-D call on lane i, to the
    rounding of a batched against a single small GEMM.  The MGS lanes
    carry a masked row and a dependent one, which it drops."""
    lanes, p, d = 3, 6, 400
    b = _blk(rng, lanes, p, d)
    hb = _blk(rng, lanes, p, d)
    mask = torch.ones((lanes, p), dtype=torch.float64)
    mask[2, 5] = 0.0
    b[2, 5] = 0.0
    q, hq = trr.masked_loewdin(b, mask, 1e-13, hblock=hb, passes=2)
    a = _blk(rng, lanes, d, d)
    h = a @ a.mH / d + 2.0 * torch.eye(d, dtype=a.dtype)
    hs = b @ h.mT
    theta, c = trr.rayleigh_ritz(b[:2], hs[:2])
    bm = b.clone()
    bm[1, 4] = bm[1, 0] + 2j * bm[1, 1]
    base = torch.linalg.qr(_blk(rng, lanes, d, 2))[0].mT.contiguous()
    mq, mhq, keep = trr.masked_mgs(bm, mask, 1e-6, hblock=2 * bm,
                                   against=(base,), h_against=(3 * base,))
    assert keep.sum(-1).tolist() == [6.0, 5.0, 5.0]
    for i in range(lanes):
        qi, hqi = trr.masked_loewdin(b[i], mask[i], 1e-13, hblock=hb[i],
                                     passes=2)
        torch.testing.assert_close(q[i], qi, rtol=0, atol=1e-13)
        torch.testing.assert_close(hq[i], hqi, rtol=0, atol=1e-13)
        if i < 2:
            ti, ci = trr.rayleigh_ritz(b[i], hs[i])
            torch.testing.assert_close(theta[i], ti, rtol=0,
                                       atol=1e-12 * float(ti.abs().max()))
            torch.testing.assert_close(c[i], ci, rtol=0, atol=1e-10)
        mqi, mhqi, ki = trr.masked_mgs(bm[i], mask[i], 1e-6, hblock=2 * bm[i],
                                       against=(base[i],),
                                       h_against=(3 * base[i],))
        torch.testing.assert_close(keep[i], ki, rtol=0, atol=0)
        torch.testing.assert_close(mq[i], mqi, rtol=0, atol=1e-12)
        torch.testing.assert_close(mhq[i], mhqi, rtol=0, atol=1e-12)
    assert not hq[2, 5].any() and not q[2, 5].any()


FCC_ROWS = (9, 10, 11)


@pytest.mark.parametrize("diel_type,eps_opt", [("chiral", 0),
                                               ("pseudochiral_crossdof", 3)])
def test_solve_batch_matches_jax_batch(monkeypatch, diel_type, eps_opt):
    """(d) ``KPointSolver(solver_impl="complex").solve_batch`` of three fcc
    points at N=12 against JAX's ``solve_batch`` through its vmapped
    ``_jitted_batch`` from the same starts: omega_re within 1e-7.  The
    port runs one lane solve: ``solve`` is never called."""
    from pcx.lattices import k_path
    alphas = [k_path("fcc")[i] for i in FCC_ROWS]
    js, pair = _pair_solvers("fcc", 12, 4, jnp.complex128,
                             torch.complex128, diel_type=diel_type,
                             eps_opt=eps_opt, impl="complex")
    # the port's complex route on the same state
    ts = bs.KPointSolver(pair.cfg, device="cpu", dtype=torch.complex128,
                         diel=pair.diel, parts=pair.parts,
                         solver_impl="complex")
    assert js.impl == ts.impl == "complex" and not js.dev_sym
    batch = js._jitted_batch
    calls = []
    monkeypatch.setattr(js, "_jitted_batch",
                        lambda *a: calls.append(a) or batch(*a))
    x0s = [_x0(ts, a, seed=i) for i, a in enumerate(alphas)]
    rj = js.solve_batch(alphas, x0s=[boundary.encode(x) for x in x0s])
    assert calls

    def no_serial(*a, **k):
        raise AssertionError("solve_batch ran the serial solve")

    monkeypatch.setattr(bs.KPointSolver, "solve", no_serial)
    rt = ts.solve_batch(alphas, x0s=[interop.block(x, torch.complex128,
                                                   "cpu") for x in x0s])
    for a, b in zip(rt, rj):
        assert a.status == b.status == Status.CONVERGED
        np.testing.assert_allclose(a.omega_re, b.omega_re, rtol=0,
                                   atol=OMEGA_TOL)
        assert a.wall_time == rt[0].wall_time and a.widths is None


SWEEP = dict(n=8, lattice="sc_flat1", nev=4, gap=4)
SWEEP_ROWS = [0, 1, 2, 3, 4, 5]


def test_bandgap_k_batch_lanes_match_serial_sweep(tmp_path, monkeypatch):
    """(e) ``bandgap(k_batch=3)`` with ``solver_impl="complex"`` (two lane
    groups, the second warm from the first's last block) against
    ``bandgap(k_batch=1)`` on the same rows: frequencies within 1e-7, the
    two library files equal in schema, the groups solved as lanes of
    one body, the serial rows as its one-lane case."""
    groups = []
    lanes = bs.lobpcg_sep_lanes

    def spy(h, p, x0, *a, **k):
        groups.append(x0.shape[0])
        return lanes(h, p, x0, *a, **k)

    monkeypatch.setattr(bs, "lobpcg_sep_lanes", spy)
    libs = {}
    for k_batch in (1, 3):
        out = tmp_path / f"kb{k_batch}"
        err = bs.bandgap(output_dir=str(out), indices=SWEEP_ROWS,
                         k_batch=k_batch, verbose=False, device="cpu",
                         dtype=torch.complex128,
                         solver_kw={"solver_impl": "complex"}, **SWEEP)
        assert err == []
        with open(os.path.join(out, "chiral", "bandgap_sc_flat1.json")) as f:
            libs[k_batch] = json.load(f)
    # k_batch=1: each row's solve is the one-lane body; k_batch=3: two groups
    assert groups == [1] * len(SWEEP_ROWS) + [3, 3]
    a, b = libs[1], libs[3]
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.shape(a[key]) == np.shape(b[key]), key
    freq = "sc_flat1_8_frequencies"
    np.testing.assert_allclose(np.asarray(b[freq])[SWEEP_ROWS],
                               np.asarray(a[freq])[SWEEP_ROWS], rtol=0,
                               atol=OMEGA_TOL)
    its = np.asarray(b["sc_flat1_8_iterations"])
    assert (its[SWEEP_ROWS, 0] > 0).all()
    assert (its[len(SWEEP_ROWS):, 0] <= 0).all()
