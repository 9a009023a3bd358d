"""The lockstep k-point batch of the port (``lobpcg_sep_rs_lanes``,
kernels K1 and K3 on a lane axis, ``KPointSolver.solve_batch`` and
``bandgap(k_batch=)``) against the JAX package's vmapped batch
(``jax.vmap`` of ``pcx.solvers.lobpcg_rs.lobpcg_sep_rs``, which
``_jitted_batch_rs`` runs) and against the port's own serial solves, on
the CPU in complex128 (the kernels' plain versions in float32)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcx import boundary
from pcx.operators.pallas_kernels import (fused_gram9_pairs,
                                          fused_resid_precond)
from pcx.solvers import lobpcg_rs as jrs
from pcx.solvers.lobpcg import Status
from pcx_torch import bandstructure as bs
from pcx_torch import interop
from pcx_torch.config import ProblemConfig
from pcx_torch.kernels import resid_precond
from pcx_torch.kernels.gram9 import gram9, gram9_plain
from pcx_torch.kernels.resid_precond import resid_precond_plain
from pcx_torch.solvers import lobpcg_rs as trs
from pcx_torch.solvers import rayleigh_ritz as trr

from test_torch_solver import _pair_solvers, _x0

torch.set_num_threads(min(torch.get_num_threads(), 2))

N_DIM, NEV, M = 100, 5, 9
# Three distinct evenly spaced spectra, one per lane (the separated spectra
# of tests/test_torch_wcap.py): on a clustered one (geometric, condition
# 200) the iteration count of a solve moves with rounding, by 14 of ~250
# between the JAX and the port's serial solver from the same start.  The
# Ritz values keep the graded split of ``eigh_split`` (1e-10 max|T|) on
# both sides, in different basis orders, so the operators' norms stay near
# 10 for the 1e-10 gate (at 50-80 the lanes and JAX differ by 1.3e-10).
SPECTRA = ((1.0, 10.0), (2.0, 12.0), (0.5, 8.0))
OMEGA_TOL = 1e-7


def _hpd(rng, n, lo, hi):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return (q * np.linspace(lo, hi, n)) @ q.conj().T


def _problems(rng):
    """Three dense HPD operators and one start block per lane."""
    mats = np.stack([_hpd(rng, N_DIM, *s) for s in SPECTRA])
    x0 = rng.normal(size=(3, M, N_DIM)) + 1j * rng.normal(size=(3, M, N_DIM))
    return mats, x0


def _port_lanes(mats, x0, **kw):
    ats = [torch.as_tensor(a) for a in mats]

    def h(v, lanes):
        return torch.stack([v[i] @ ats[j].T for i, j in enumerate(lanes)])

    return trs.lobpcg_sep_rs_lanes(h, lambda v, lanes: v,
                                   torch.as_tensor(x0), NEV, **kw)


def _port_serial(a, x0, **kw):
    at = torch.as_tensor(a)
    return trs.lobpcg_sep_rs(lambda v: v @ at.T, lambda v: v,
                             torch.as_tensor(x0), NEV, **kw)


@pytest.mark.parametrize("w_cap", [None, 4])
def test_lanes_match_jax_vmapped_batch(rng, w_cap):
    """(a) Three lanes of distinct operators against ``jax.vmap`` of the
    JAX solver over per-lane operators and starts: per lane the same
    status, iterations within one, the lowest NEV Ritz values within
    1e-10."""
    mats, x0 = _problems(rng)
    kw = dict(tol=1e-8, maxiter=300, w_cap=w_cap)

    def one(ar, ai, xr, xi):
        def h(v):
            return (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)
        return jrs.lobpcg_sep_rs(h, lambda v: v, (xr, xi), NEV, **kw)

    rj = jax.vmap(one)(jnp.asarray(mats.real), jnp.asarray(mats.imag),
                       jnp.asarray(x0.real), jnp.asarray(x0.imag))
    got = _port_lanes(mats, x0, **kw)
    for lane, r in enumerate(got):
        assert r.status == int(rj.status[lane]) == Status.CONVERGED
        assert abs(r.iterations - int(rj.iterations[lane])) <= 1, lane
        np.testing.assert_allclose(r.lambdas[:NEV].numpy(),
                                   np.asarray(rj.lambdas[lane][:NEV]),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("w_cap", [None, 4, "auto"])
def test_lanes_match_serial_solves(rng, w_cap):
    """(b) Each lane against the port's serial ``lobpcg_sep_rs`` with that
    lane's options: lane 0 is cut by its limit (a warm cap) and leaves the
    batch early, lane 1 stops by its monitor, and the three refresh at
    different periods.  The lane computes what its serial solve computes:
    status, iterations and widths equal, Ritz values to 1e-12."""
    mats, x0 = _problems(rng)
    refresh, limits = [5, 3, 8], [12, None, None]
    stop_at = {1: 20}

    def monitor(lane):
        if lane not in stop_at:
            return None
        return lambda it, res, lam: it >= stop_at[lane]

    kw = dict(tol=1e-8, maxiter=300, w_cap=w_cap,
              col_patience=3 if w_cap == "auto" else 0)
    widths = [[] for _ in range(3)]
    got = _port_lanes(mats, x0, refresh_every=refresh, limit=limits,
                      monitor=[monitor(i) for i in range(3)], widths=widths,
                      **kw)
    assert got[0].iterations == 12 and got[0].status == Status.MAXITER
    assert got[1].iterations == 20 and got[1].status == Status.MAXITER
    assert got[2].status == Status.CONVERGED
    for lane, r in enumerate(got):
        w = []
        s = _port_serial(mats[lane], x0[lane], refresh_every=refresh[lane],
                         limit=limits[lane], monitor=monitor(lane), widths=w,
                         **kw)
        assert (r.status, r.iterations) == (s.status, s.iterations), lane
        np.testing.assert_allclose(r.lambdas.numpy(), s.lambdas.numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(r.res_history, s.res_history)
        if w_cap == "auto":
            # every lane runs at the batch's bucket, at least its own
            assert all(a >= b for a, b in zip(widths[lane], w)), lane
        else:
            assert widths[lane] == w, lane


def test_rayleigh_ritz_lane_helpers_equal_2d_calls(rng):
    """The lane forms of the Rayleigh-Ritz helpers: lane i of each equals
    the 2-D call on lane i (to the rounding of a batched against a single
    CPU GEMM, 1e-15 of the scale)."""
    def blk(*s):
        return torch.as_tensor(rng.normal(size=s) + 1j * rng.normal(size=s))

    x, y, c = blk(3, 6, 3000), blk(3, 4, 3000), blk(3, 6, 5)
    g = trr.gram_f64(x, y, chunk=700)
    h = trr.hermitize(blk(3, 8, 8))
    w, v = trr.eigh_split(h, 1e-10)
    b = blk(3, 6, 400)
    b[1, 4] = b[1, 0] + 2j * b[1, 1]
    mask = torch.ones((3, 6), dtype=torch.float64)
    mask[2, 5] = 0.0
    base = torch.linalg.qr(blk(3, 400, 2))[0].mT.contiguous()
    q, hq, keep = trr.masked_svqb_drop(b, mask, 1e-6, hblock=2 * b,
                                       against=(base,), h_against=(base,))
    tol = 1e-14 * float(g.abs().max())
    for i in range(3):
        torch.testing.assert_close(g[i], trr.gram_f64(x[i], y[i], chunk=700),
                                   rtol=0, atol=tol)
        torch.testing.assert_close(trr.mix(c, x)[i], trr.mix(c[i], x[i]),
                                   rtol=0, atol=1e-13)
        torch.testing.assert_close(trr.colnorms(x, lanes=True)[i],
                                   trr.colnorms(x[i]), rtol=0, atol=0)
        wi, vi = trr.eigh_split(h[i], 1e-10)
        torch.testing.assert_close(w[i], wi, rtol=0, atol=1e-13)
        qi, hqi, ki = trr.masked_svqb_drop(b[i], mask[i], 1e-6,
                                           hblock=2 * b[i], against=(base[i],),
                                           h_against=(base[i],))
        torch.testing.assert_close(keep[i], ki, rtol=0, atol=0)
        torch.testing.assert_close(q[i], qi, rtol=0, atol=1e-12)
        torch.testing.assert_close(hq[i], hqi, rtol=0, atol=1e-12)
    assert keep.sum(-1).tolist() == [6.0, 5.0, 5.0]


def _k1_lanes(rng, lanes, m, d):
    c = lambda *s: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(
        np.complex64)
    return (c(lanes, m, 3, d), c(lanes, m, 3, d),
            rng.normal(size=(lanes, m)).astype(np.float32),
            rng.normal(size=(lanes, 3, d)).astype(np.float32),
            c(lanes, 3, d))


def test_k1_plain_lanes_match_vmapped_pallas_interpret(rng):
    """(c) K1's plain version on a lane axis against ``jax.vmap`` of the
    Pallas kernel in interpret mode (f32 both sides, rtol 1e-5), and lane
    i against the call without a lane axis on lane i."""
    lanes, m, d = 3, 5, 1537     # D not a multiple of the Pallas chunk
    x, hx, lam, idg, isd = _k1_lanes(rng, lanes, m, d)
    pair = lambda a: (jnp.asarray(a.real), jnp.asarray(a.imag))

    def one(x, hx, lam, idg, isd):
        return fused_resid_precond(x, hx, lam, idg, isd, chunk=512,
                                   interpret=True)

    (wr, wi), ss = jax.vmap(one)(pair(x), pair(hx), jnp.asarray(lam),
                                 jnp.asarray(idg), pair(isd))
    args = [torch.as_tensor(a) for a in (x, hx, lam, idg, isd)]
    n0 = resid_precond.launches
    w, sumsq = resid_precond(*args)
    assert resid_precond.launches == n0    # the plain version: no launch
    assert w.shape == (lanes, m, 3, d) and sumsq.shape == (lanes, m)
    np.testing.assert_allclose(np.sqrt(sumsq.numpy()), np.sqrt(np.asarray(ss)),
                               rtol=1e-5)
    np.testing.assert_allclose(w.numpy().real, np.asarray(wr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(w.numpy().imag, np.asarray(wi), rtol=1e-5,
                               atol=1e-5)
    for i in range(lanes):
        wi_, si_ = resid_precond(*(a[i] for a in args))
        torch.testing.assert_close(w[i], wi_, rtol=0, atol=0)
        torch.testing.assert_close(sumsq[i], si_, rtol=1e-6, atol=0)
    torch.testing.assert_close(resid_precond_plain(*args)[0], w)


def test_k3_plain_lanes_match_vmapped_pallas_interpret(rng):
    """(c) K3's plain version on a lane axis against ``jax.vmap`` of the
    Pallas kernel in interpret mode (f32 chunk partials summed in f64 both
    sides, rtol 1e-5), lane i against the call without a lane axis on
    lane i, and a block of neither shape refused."""
    lanes, m, d, chunk = 3, 4, 5000, 1024
    blocks = [(rng.normal(size=(lanes, m, d))
               + 1j * rng.normal(size=(lanes, m, d))).astype(np.complex64)
              for _ in range(6)]

    def one(*planes):
        return fused_gram9_pairs(*zip(planes[::2], planes[1::2]),
                                 chunk=chunk, interpret=True)

    t_re, t_im = jax.vmap(one)(*(jnp.asarray(p) for a in blocks
                                 for p in (a.real, a.imag)))
    want = np.asarray(t_re) + 1j * np.asarray(t_im)
    tb = [torch.as_tensor(a) for a in blocks]
    n0 = gram9.launches
    got = gram9(*tb, chunk=chunk)
    assert gram9.launches == n0    # the plain version: no launch
    assert got.dtype == torch.complex128 and got.shape == (lanes, 3 * m,
                                                           3 * m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    for i in range(lanes):
        torch.testing.assert_close(got[i], gram9(*(a[i] for a in tb),
                                                 chunk=chunk),
                                   rtol=0, atol=1e-9)
    torch.testing.assert_close(gram9_plain(*tb, chunk=chunk), got)
    for bad in ([a[0, 0] for a in tb], [a[None] for a in tb]):
        with pytest.raises(ValueError, match="gram9"):
            gram9(*bad)


FCC_ROWS = (9, 10, 11)


@pytest.mark.parametrize("diel_type,eps_opt", [("chiral", 0),
                                               ("pseudochiral_crossdof", 3)])
def test_solve_batch_matches_jax_batch(monkeypatch, diel_type, eps_opt):
    """(d) ``solve_batch`` of three fcc points at N=12 against JAX's
    ``solve_batch`` through ``_jitted_batch_rs`` from the same starts:
    omega_re within 1e-7.  The port runs one lane solve: ``solve`` is never
    called."""
    from pcx.lattices import k_path
    alphas = [k_path("fcc")[i] for i in FCC_ROWS]
    js, ts = _pair_solvers("fcc", 12, 4, jnp.complex128, torch.complex128,
                           diel_type=diel_type, eps_opt=eps_opt)
    assert js.segment_iters == 0 and js.dev_sym
    x0s = [_x0(ts, a, seed=i) for i, a in enumerate(alphas)]
    rj = js.solve_batch(alphas, x0s=[boundary.encode(x) for x in x0s])

    def no_serial(*a, **k):
        raise AssertionError("solve_batch ran the serial solve")

    monkeypatch.setattr(bs.KPointSolver, "solve", no_serial)
    rt = ts.solve_batch(alphas, x0s=[interop.block(x, torch.complex128,
                                                   "cpu") for x in x0s])
    for a, b in zip(rt, rj):
        assert a.status == b.status == Status.CONVERGED
        np.testing.assert_allclose(a.omega_re, b.omega_re, rtol=0,
                                   atol=OMEGA_TOL)
        assert a.wall_time == rt[0].wall_time and len(a.widths) == \
            a.iterations


def test_solve_batch_paths(monkeypatch):
    """Which path a group takes: complex64 softlock with rr_gram="pallas"
    runs one lane solve through K1 and K3 on the lane axis; a group of one
    runs one lane of the same driver, through the one-lane entry
    ``lobpcg_sep_rs`` (the name the benchmark's planted faults patch);
    solver_impl="complex" runs one
    ``lobpcg_sep_lanes``; Davidson and JD, under either impl, run ``solve``
    per member; a group that mixes block widths raises."""
    from pcx.lattices import k_path
    alphas = [k_path("fcc")[i] for i in FCC_ROWS]
    calls = {"k1": [], "k3": [], "solve": 0, "group": [], "one": 0}
    k1, k3, solve, group, one = (bs.resid_precond, trs.gram9,
                                 bs.KPointSolver.solve,
                                 bs.KPointSolver._solve_group,
                                 bs.lobpcg_sep_rs)

    def k1_spy(*a):
        calls["k1"].append(a[0].shape[0])
        return k1(*a)

    def k3_spy(*a, **k):
        calls["k3"].append(a[0].shape[0])
        return k3(*a, **k)

    def solve_spy(self, *a, **k):
        calls["solve"] += 1
        return solve(self, *a, **k)

    def group_spy(self, alphas, *a, **k):
        calls["group"].append(len(alphas))
        return group(self, alphas, *a, **k)

    def one_spy(*a, **k):
        calls["one"] += 1
        return one(*a, **k)

    monkeypatch.setattr(bs, "lobpcg_sep_rs", one_spy)
    monkeypatch.setattr(bs, "resid_precond", k1_spy)
    monkeypatch.setattr(trs, "gram9", k3_spy)
    monkeypatch.setattr(bs.KPointSolver, "solve", solve_spy)
    monkeypatch.setattr(bs.KPointSolver, "_solve_group", group_spy)
    cfg = ProblemConfig(n=8, lattice="fcc", nev=4)
    kps = bs.KPointSolver(cfg, device="cpu", dtype=torch.complex64,
                          tol=1e-5, solver_opts={"rr_gram": "pallas"})
    res = kps.solve_batch(alphas, seed=3)
    assert calls["solve"] == 0 and calls["k1"] and calls["k3"]
    assert calls["k1"][0] == calls["k3"][0] == 3 and calls["group"] == [3]
    assert calls["one"] == 0
    assert all(r.status in (Status.CONVERGED, Status.FLOOR) for r in res)
    assert not any(r.report.spurious for r in res)
    calls["k1"].clear()
    calls["k3"].clear()
    kps.solve_batch(alphas[:1])
    assert calls["solve"] == 0 and calls["group"] == [3, 1]
    assert calls["one"] == 1
    assert set(calls["k1"]) == set(calls["k3"]) == {1}
    for kw in ({"solver": "davidson"}, {"solver": "jd"},
               {"solver": "jd", "solver_impl": "complex"}):
        calls["solve"] = 0
        bs.KPointSolver(cfg, device="cpu", dtype=torch.complex128,
                        tol=1e-6, **kw).solve_batch(alphas[:2])
        assert calls["solve"] == 2, kw
    lanes, complex_lanes = [], bs.lobpcg_sep_lanes

    def complex_spy(h, p, x0, *a, **k):
        lanes.append(x0.shape[0])
        return complex_lanes(h, p, x0, *a, **k)

    monkeypatch.setattr(bs, "lobpcg_sep_lanes", complex_spy)
    calls["solve"] = 0
    bs.KPointSolver(cfg, device="cpu", dtype=torch.complex128, tol=1e-6,
                    solver_impl="complex").solve_batch(alphas[:2])
    assert calls["solve"] == 0 and lanes == [2]
    # every k-point of the paths has one width (config.set_relaxation's
    # ratio is constant): a solver that gives two widths stands in
    monkeypatch.setattr(kps, "block_width", lambda a: 6 if a[0] > 1 else 5)
    with pytest.raises(ValueError, match="mixes block widths"):
        kps.solve_batch([np.zeros(3), np.full(3, 2.0)])


SWEEP = dict(n=8, lattice="sc_flat1", nev=4, gap=4)
SWEEP_ROWS = [0, 1, 2, 3, 4, 5]


def test_bandgap_k_batch_lanes_match_serial_sweep(tmp_path):
    """(e) ``bandgap(k_batch=3)`` (two lane groups, the second warm from the
    first's last block) against ``bandgap(k_batch=1)`` on the same rows:
    frequencies within 1e-7, the two library files equal in schema."""
    libs = {}
    for k_batch in (1, 3):
        out = tmp_path / f"kb{k_batch}"
        err = bs.bandgap(output_dir=str(out), indices=SWEEP_ROWS,
                         k_batch=k_batch, verbose=False, device="cpu",
                         dtype=torch.complex128, **SWEEP)
        assert err == []
        with open(os.path.join(out, "chiral", "bandgap_sc_flat1.json")) as f:
            libs[k_batch] = json.load(f)
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
