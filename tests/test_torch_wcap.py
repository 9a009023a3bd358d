"""The W/P width cap ``w_cap`` of the port's production LOBPCG and its
``maxstagniter`` against the JAX package on the CPU: the solver on dense
Hermitian positive-definite matrices (tests/test_lobpcg.py:399-565, each
held against JAX's run from the same start), ``KPointSolver`` with an int
cap and with ``"auto"``, and the refusals of both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import boundary
from pcx import bandstructure as jbs
from pcx.config import ProblemConfig as JaxConfig
from pcx.solvers import lobpcg_rs as jrs
from pcx.solvers.lobpcg import Status
from pcx_torch import interop
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.solvers import lobpcg_rs as trs

from test_torch_solver import _pair_solvers, _x0

torch.set_num_threads(min(torch.get_num_threads(), 2))

N_DIM, NEV = 100, 5
# complex128 on both sides from the same start: the small eigenproblems
# differ (complex eigh against the real embedding), as in
# tests/test_torch_solver.py:205-210
ITER_SLACK, RITZ_TOL, OMEGA_TOL = 2, 1e-8, 1e-8


def _random_hpd(n, rng, cond=50.0):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.conj().T


def _separated(n, rng):
    """HPD with the evenly spaced spectrum 1..50 and its lowest NEV."""
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    lam = np.linspace(1.0, 50.0, n)
    return (q * lam) @ q.conj().T, lam[:NEV]


def _rs(*args, **kw):
    """The port's solver: its result and the width of each iteration."""
    widths = []
    res = trs.lobpcg_sep_rs(*args, widths=widths, **kw)
    return res, np.asarray(widths)


def _ops(a, x0c, rdt=jnp.float64):
    """(JAX pair operator, JAX pair start, port operator, port start)."""
    ar, ai = jnp.asarray(a.real, rdt), jnp.asarray(a.imag, rdt)
    cdt = torch.complex128 if rdt == jnp.float64 else torch.complex64
    at = torch.as_tensor(a).to(cdt)
    return ((lambda v: (v[0] @ ar.T - v[1] @ ai.T,
                        v[0] @ ai.T + v[1] @ ar.T)),
            (jnp.asarray(x0c.real, rdt), jnp.asarray(x0c.imag, rdt)),
            (lambda v: v @ at.T), torch.as_tensor(x0c).to(cdt))


def _ident(v):
    return v


def _start(rng, m, n=N_DIM):
    return rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))


def _match(rt, rj, nev=NEV):
    assert rt.status == int(rj.status) == Status.CONVERGED
    assert abs(rt.iterations - int(rj.iterations)) <= ITER_SLACK
    np.testing.assert_allclose(rt.lambdas[:nev].numpy(),
                               np.asarray(rj.lambdas[:nev]), rtol=0,
                               atol=RITZ_TOL)


def test_full_width_is_no_cap_exactly(rng):
    """w_cap == m gathers nothing: the run of w_cap=None, bit for bit, and
    both agree with JAX's full-width run."""
    a = _random_hpd(N_DIM, rng)
    hj, xj, ht, xt = _ops(a, _start(rng, NEV + 4))
    kw = dict(tol=1e-8, maxiter=300)
    base = trs.lobpcg_sep_rs(ht, _ident, xt, NEV, **kw)
    capd, widths = _rs(ht, _ident, xt, NEV, w_cap=NEV + 4, **kw)
    assert capd.status == base.status == Status.CONVERGED
    assert capd.iterations == base.iterations
    np.testing.assert_array_equal(capd.lambdas.numpy(), base.lambdas.numpy())
    assert (widths == NEV + 4).all() and len(widths) == capd.iterations
    _match(capd, jrs.lobpcg_sep_rs(hj, _ident, xj, NEV, w_cap=NEV + 4, **kw))


@pytest.mark.parametrize("wc", [4, 2])
def test_compacted_w_cap_matches_jax(rng, wc):
    """W/P capped below m (worst case: below the active count) converges to
    the same eigenvalues in the iterations of JAX's run."""
    a, want = _separated(N_DIM, rng)
    hj, xj, ht, xt = _ops(a, _start(rng, NEV + 4))
    kw = dict(tol=1e-8, maxiter=300, w_cap=wc)
    rt, widths = _rs(ht, _ident, xt, NEV, **kw)
    _match(rt, jrs.lobpcg_sep_rs(hj, _ident, xj, NEV, **kw))
    np.testing.assert_allclose(rt.lambdas[:NEV].numpy(), want, rtol=1e-6)
    assert (widths == wc).all()


def test_no_starvation_without_locking(rng):
    """With locking off the active set never shrinks, so w_cap=2 must
    rotate its slots by residual (tests/test_lobpcg.py:448-471)."""
    nev = 4
    a, want = _separated(N_DIM, rng)
    hj, xj, ht, xt = _ops(a, _start(rng, nev + 2))
    kw = dict(tol=1e-8, maxiter=300, locking=False, w_cap=2)
    rt = trs.lobpcg_sep_rs(ht, _ident, xt, nev, **kw)
    _match(rt, jrs.lobpcg_sep_rs(hj, _ident, xj, nev, **kw), nev)
    np.testing.assert_allclose(rt.lambdas[:nev].numpy(), want[:nev],
                               rtol=1e-6)


def test_width_schedule_matches_jax_bucket_switch(rng):
    """The widths m, m/2, m/4, m/2, m in turn, six iterations each, through
    the width hook, against JAX's trampoline re-entering through the
    matching bucket programs (tests/test_lobpcg.py:474-504)."""
    m = NEV + 4
    a = _random_hpd(N_DIM, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:NEV]
    hj, xj, ht, xt = _ops(a, _start(rng, m))
    caps, seg = [m, m // 2, m // 4, m // 2, m], 6

    def mk(wc):
        return jrs.rs_solver_parts(hj, _ident, xj[0].shape, xj[0].dtype, NEV,
                                   tol=1e-8, maxiter=400, w_cap=wc)
    init, _, finalize = mk(m)
    runs = {wc: mk(wc)[1] for wc in set(caps)}
    state, it = init(xj), 0
    for s in range(80):
        state = runs[caps[s % len(caps)]](state, min(it + seg, 400))
        it = int(state["it"])
        if int(state["status"]) != Status.RUNNING or it >= 400:
            break
    rj = finalize(state)
    rt, widths = _rs(ht, _ident, xt, NEV, tol=1e-8, maxiter=400,
                     w_cap=lambda it, n_act: caps[(it // seg) % len(caps)])
    _match(rt, rj)
    np.testing.assert_allclose(rt.lambdas[:NEV].numpy(), want, rtol=1e-6)
    assert list(widths[:3 * seg]) == [m] * seg + [m // 2] * seg + \
        [m // 4] * seg


def test_active_count_falls_under_col_patience_f32(rng):
    """complex64 with an unattainable tolerance: per-column floor locks
    take the active count below m (seen through the width hook), ``"auto"``
    runs narrower buckets once it falls to m/2, and the solves end FLOOR at
    JAX's attainable accuracy
    (tests/test_lobpcg.py:508-542)."""
    m = NEV + 4
    a = _random_hpd(N_DIM, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:NEV]
    hj, xj, ht, xt = _ops(a, _start(rng, m), jnp.float32)
    kw = dict(tol=1e-12, maxiter=200, col_patience=5, floor_patience=8)
    rj = jrs.lobpcg_sep_rs(hj, _ident, xj, NEV, **kw)
    assert int(rj.status) == Status.FLOOR
    n_acts = []

    def hook(it, n_act):
        n_acts.append(n_act)
        return m

    rt = trs.lobpcg_sep_rs(ht, _ident, xt, NEV, w_cap=hook, **kw)
    # a shorter column patience locks enough columns for the m/2 bucket
    auto, widths = _rs(ht, _ident, xt, NEV, w_cap="auto",
                       **dict(kw, col_patience=3))
    assert rt.status == auto.status == Status.FLOOR
    assert min(n_acts) < m
    assert min(widths) < m
    assert set(widths) <= set(trs.w_buckets(m))
    for r in (rt, auto):
        np.testing.assert_allclose(r.lambdas[:NEV].numpy(), want, rtol=2e-4)
    np.testing.assert_allclose(rt.lambdas[:NEV].numpy(),
                               np.asarray(rj.lambdas[:NEV]), rtol=2e-4)


def _omega_pair(opts, jax_kw=None, lattice="sc_flat1",
                alpha=(np.pi / 2, 0.0, 0.0)):
    """(port result, JAX result, start block) of ``lattice`` N=8 nev=4 from
    one start block, complex128, the port with ``opts``; JAX with
    ``jax_kw`` (else its one-shot CPU program with ``opts``).  With
    ``opts=None`` the port runs its defaults and JAX does not run."""
    alpha = np.asarray(alpha)
    jkw = jax_kw or {"solver_opts": dict(opts or {})}
    jkw.setdefault("solver_opts", {}).update(warm_maxiter=0,
                                             doom_check=False)
    js, ts = _pair_solvers(lattice, 8, 4, jnp.complex128, torch.complex128,
                           jax_kw=jkw, torch_opts=opts)
    x0 = _x0(ts, alpha, seed=3)
    rt = ts.solve(alpha, x0=interop.block(x0, torch.complex128, "cpu"))
    rj = None if opts is None else js.solve(alpha, x0=boundary.encode(x0))
    return rt, rj, ts.block_width(alpha)


def test_kpoint_solver_auto_matches_jax_segmented_and_default():
    """{"w_cap": "auto", "col_patience": 6} through KPointSolver against
    JAX's trampolined solve with the same options at segment_iters=1 (a
    bucket every iteration) and against the port's default: the buckets
    drop only directions of inactive columns, so the frequencies stay
    (tests/test_lobpcg.py:545-565).  At fcc (pi, 0.2, 0) the active count
    falls to m/2 before the solve converges."""
    opts = {"w_cap": "auto", "col_patience": 6}
    where = dict(lattice="fcc", alpha=(np.pi, 0.2, 0.0))
    rt, rj, m = _omega_pair(opts, jax_kw={"segment_iters": 1,
                                          "solver_opts": dict(opts)},
                            **where)
    base, _, _ = _omega_pair(None, **where)
    assert rt.status in (1, 5) and rj.status in (1, 5)
    assert min(rt.widths) < max(rt.widths) == m
    assert set(rt.widths) <= set(trs.w_buckets(m))
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-7)
    np.testing.assert_allclose(rt.omega_re, base.omega_re, atol=1e-7)
    assert np.abs(rt.omega - rt.omega_re).max() < 1e-3


def test_kpoint_solver_int_w_cap_matches_jax_oneshot():
    """An int cap through KPointSolver against JAX's one-shot CPU program,
    which keeps an int cap (pcx/bandstructure.py:155-164)."""
    rt, rj, _ = _omega_pair({"w_cap": 4})
    assert rt.status == rj.status == Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= ITER_SLACK
    assert (rt.widths == 4).all()
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=OMEGA_TOL)


def test_maxstagniter_matches_jax(rng):
    """A solve that cannot move (a zero preconditioner and no conjugate
    block) on a matrix whose residuals stay above 1000: the stagnation
    guard ends it BLOWUP right after ``maxstagniter`` iterations, in both
    packages and for two values."""
    a = 1e5 * _random_hpd(N_DIM, rng)
    hj, xj, ht, xt = _ops(a, _start(rng, NEV + 4))
    zero = lambda v: v * 0.0          # noqa: E731
    zero_p = lambda v: (v[0] * 0.0, v[1] * 0.0)   # noqa: E731
    iters = []
    for ms in (7, 50):
        kw = dict(tol=1e-8, maxiter=300, maxstagniter=ms, use_p=False)
        rt = trs.lobpcg_sep_rs(ht, zero, xt, NEV, **kw)
        rj = jrs.lobpcg_sep_rs(hj, zero_p, xj, NEV, **kw)
        assert rt.status == int(rj.status) == Status.BLOWUP
        assert rt.iterations == int(rj.iterations) == ms + 1
        iters.append(rt.iterations)
    opts = {"maxstagniter": 7, "w_cap": 4}
    ts = KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                      device="cpu", dtype=torch.complex128,
                      solver_opts=dict(opts))
    assert ts.solver_opts == opts


def _jax_w_cap_error(value):
    with pytest.raises(ValueError) as e:
        jbs._filter_rs_opts({"w_cap": value})
    return str(e.value)


@pytest.mark.parametrize("value", [2.5, True, "full", "8"])
def test_bad_w_cap_is_refused_as_jax_refuses_it(value):
    with pytest.raises(ValueError) as e:
        KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                     device="cpu", dtype=torch.complex128,
                     solver_opts={"w_cap": value})
    assert str(e.value) == _jax_w_cap_error(value)


def test_w_cap_refusals_match_jax(rng):
    """rr_gram="pallas" refuses "auto" (at construction) and a cap below
    the block width (at the solve), as both JAX routes do; Davidson, JD and
    solver_impl="complex" refuse the key."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    kw = dict(device="cpu", dtype=torch.complex128)
    alpha = np.array([np.pi, 0.0, 0.0])
    with pytest.raises(ValueError, match="rr_gram='pallas'"):
        KPointSolver(cfg, solver_opts={"w_cap": "auto", "rr_gram": "pallas"},
                     **kw)
    with pytest.raises(ValueError, match="rr_gram='pallas'"):
        KPointSolver(cfg, solver_opts={"w_cap": 4, "rr_gram": "pallas"},
                     **kw).solve(alpha)
    hj, xj, ht, xt = _ops(_random_hpd(N_DIM, rng), _start(rng, NEV + 4))
    for solver in (jrs.lobpcg_sep_rs, trs.lobpcg_sep_rs):
        x = xj if solver is jrs.lobpcg_sep_rs else xt
        h = hj if solver is jrs.lobpcg_sep_rs else ht
        with pytest.raises(ValueError, match="rr_gram='pallas'"):
            solver(h, _ident, x, NEV, w_cap=4, rr_gram="pallas")
    # a cap at the block width is the uncapped solve: K3 takes it
    trs.lobpcg_sep_rs(ht, _ident, xt, NEV, w_cap=NEV + 4, rr_gram="pallas",
                      maxiter=2)
    for name in ("davidson", "jd"):
        with pytest.raises(ValueError, match="w_cap"):
            KPointSolver(cfg, solver=name, solver_opts={"w_cap": 4}, **kw)
    with pytest.raises(ValueError, match="w_cap"):
        KPointSolver(cfg, solver_impl="complex", solver_opts={"w_cap": 4},
                     **kw)
    with pytest.raises(ValueError, match="w_cap"):
        jbs.KPointSolver(JaxConfig(n=8, lattice="sc_curv", nev=4),
                         dtype=jnp.complex128, solver_impl="complex",
                         solver_opts={"w_cap": 4}).solve(alpha)
    with pytest.raises(ValueError, match="w_cap must be"):
        trs.width_rule("wide", 9)


def test_entry_points_take_w_cap_and_maxstagniter(tmp_path):
    """eigen_1p and bandgap (k-point groups through solve_batch) take both
    keys; the CLIs' KEY=VAL parsers give "auto" and an int; the tools run
    the JAX tools' lever stacks, w_cap included."""
    import ast
    import json
    import os
    from pcx_torch import bench, record_vs_truth, run_sweep
    from pcx_torch.bandstructure import bandgap, eigen_1p
    opts = {"w_cap": "auto", "col_patience": 3, "maxstagniter": 40}
    r = eigen_1p(8, "sc_flat1", np.array([np.pi, 0.2, 0.0]), nev=4,
                 device="cpu", verbose=False, solver_opts=dict(opts))
    assert r.status in (1, 5) and len(r.widths) == r.iterations
    failed = bandgap(n=8, lattice="sc_flat1", nev=4, gap=2,
                     indices=[2, 3, 4, 5], output_dir=str(tmp_path),
                     device="cpu", dtype=torch.complex128, k_batch=2,
                     solver_opts={"w_cap": 4}, verbose=False)
    with open(os.path.join(tmp_path, "chiral",
                           "bandgap_sc_flat1.json")) as f:
        rows = json.load(f)["sc_flat1_8_frequencies"]
    assert failed == []
    assert all(np.isfinite(rows[i]).all() and min(rows[i]) > 0
               for i in (2, 3, 4, 5))
    for parse in (bench.coerce, run_sweep.parse_opt):
        assert parse("w_cap=auto") == ("w_cap", "auto")
        key, val = parse("w_cap=8")
        assert (key, val) == ("w_cap", 8) and type(val) is int
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tools", "record_vs_truth.py")) as f:
        tree = ast.parse(f.read())
    stacks = [ast.literal_eval(node.value) for node in ast.walk(tree)
              if isinstance(node, ast.keyword) and node.arg == "solver_opts"]
    assert stacks == [record_vs_truth.LEVERS]
