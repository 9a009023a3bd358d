"""The keywords of the JAX package's ``KPointSolver`` in the port, against
the JAX package on identical numpy state: the light refine
(``refine="light"``) and ``refine=False``, the cold starts of ``x0_mode``
(plane wave, random, the two-grid ``"coarse"`` with ``dft.upsample_mat``
and ``resample3``), ``solver_impl="complex"`` with both ``fft_mode``s, the
sweep's escalation of a light-refine rejection, the heartbeat, the refused
TPU-only keywords, and the library checks ``bandgap_wnk_check`` and
``bandgap_history_check``."""

import inspect
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import bandstructure as jbs
from pcx import boundary
from pcx import utils as jutils
from pcx.config import ProblemConfig as JaxConfig
from pcx.config import set_relaxation as jax_relaxation
from pcx.operators import dft as jdft
from pcx_torch import bandstructure as bs
from pcx_torch import utils
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.io import BandLibrary
from pcx_torch.operators import dft
from pcx_torch.solvers.lobpcg import Status
from test_torch_solver import _pair_solvers, _x0

# Every parallel test worker imports this file: two intra-op threads each.
torch.set_num_threads(min(torch.get_num_threads(), 2))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = np.array([np.pi, 0.2, 0.0])
C64, C128 = torch.complex64, torch.complex128


@pytest.mark.parametrize("nc,n", [(6, 12), (5, 12), (4, 9), (7, 7)])
def test_upsample_and_resample3_match_pcx(nc, n):
    """The interpolation matrix (odd nc, even nc with its split Nyquist
    bin, nc = n) and the three-axis lift against pcx.operators.dft in
    complex128 to 1e-12; nc > n is refused as there."""
    u = dft.upsample_mat(nc, n)
    u_j = jdft.upsample_mat(nc, n, dtype=np.complex128)
    np.testing.assert_allclose(u, u_j, rtol=0, atol=1e-12)
    rng = np.random.default_rng(nc * n)
    x = (rng.standard_normal((2, 3, nc, nc, nc))
         + 1j * rng.standard_normal((2, 3, nc, nc, nc)))
    got = dft.resample3(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    ref = np.asarray(jdft.resample3(jnp.asarray(x), jnp.asarray(u_j)))
    assert got.shape == (2, 3, n, n, n)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="n >= nc"):
        dft.upsample_mat(n + 1, n)


def _jax_light(js, alpha, x: np.ndarray):
    """(theta, lam_re, res) of the JAX light refine of block x, with the
    arguments of pcx KPointSolver._refine_report."""
    (shift, _), pnt = jax_relaxation(alpha)
    shift = shift / js.cfg.scal ** 2
    f = js._f64
    out = js._refine_light_jit(x.shape[0])(
        f["d1"], f["d0"], f["ct"], jnp.asarray(alpha),
        jnp.asarray(np.float64(pnt)), jnp.asarray(np.float64(shift)),
        boundary.encode(x).ri, js.diel, f["wf"], f["wi"])
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("jax_dtype,dtype,rel", [
    (jnp.complex128, C128, 1e-10), (jnp.complex64, C64, 1e-5)])
def test_light_refine_matches_pcx(jax_dtype, dtype, rel):
    """``refine_light_stats`` against the JAX ``_refine_light_jit`` (its
    real-boundary pair route, the only one that runs it) on the same
    block: theta and lam_re to ``rel`` relative, the residual norms to
    ``rel`` of the operator's scale (max |theta|; the residuals are
    differences of O(scale) terms)."""
    alpha = np.array([np.pi, 0.1, 0.0])
    js, ts = _pair_solvers("sc_curv", 8, 4, jax_dtype, dtype, tol=1e-5)
    r = ts.solve(alpha, validate_result=False)
    theta_j, lam_re_j, res_j = _jax_light(js, alpha, r.x.numpy())
    theta, lam_re, res = ts.refine_light_stats(alpha, r.x)
    np.testing.assert_allclose(theta, theta_j, rtol=rel)
    np.testing.assert_allclose(lam_re, lam_re_j, rtol=rel)
    np.testing.assert_allclose(res, res_j, rtol=0,
                               atol=rel * np.abs(theta_j).max())


def test_light_refine_validates_solves_like_the_complex128_refine():
    """A complex64 solve under ``refine="light"`` validates through the
    light refine, and its report matches the complex128 refine's on the
    same block to 5e-5 (tests/test_boundary.py:100-124)."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4,
                        diel_type="pseudochiral_crossdof")
    alpha = np.array([np.pi, 0.3, 0.0])
    light = KPointSolver(cfg, device="cpu", dtype=C64, refine="light")
    heavy = KPointSolver(cfg, device="cpu", dtype=C64, refine=True,
                         diel=light.diel)
    assert (light.refine, heavy.refine) == ("light", "f64")
    calls = []
    stats = light.refine_light_stats
    light.refine_light_stats = lambda *a: calls.append(1) or stats(*a)
    r = light.solve(alpha, seed=0)
    assert calls and r.status in (Status.CONVERGED, Status.FLOOR)
    assert not r.report.spurious
    rep_h = heavy.validate_solution(alpha, r)
    np.testing.assert_allclose(r.omega_re, rep_h.omega_re, atol=5e-5)
    np.testing.assert_allclose(r.omega, rep_h.omega_pnt, atol=5e-5)
    np.testing.assert_allclose(r.report.residuals, rep_h.residuals,
                               rtol=0.2, atol=1e-5)


def _solvers(solver="softlock", impl="rs", dtype=C128, **kw):
    """A JAX solver with ``refine=False`` (the pair route in its
    real-boundary form, or the complex route) and a port solver on its
    state with ``kw``."""
    cfg = JaxConfig(n=8, lattice="sc_curv", nev=4)
    jax_dtype = jnp.complex128 if dtype == C128 else jnp.complex64
    js = jbs.KPointSolver(cfg, dtype=jax_dtype, solver=solver,
                          solver_impl=impl, refine=False,
                          real_boundary=impl == "rs")
    f = (js if impl == "rs" else jbs.KPointSolver(
        cfg, dtype=jax_dtype, solver_impl="rs", real_boundary=True,
        refine=False))._f64
    ts = KPointSolver.from_arrays(
        ProblemConfig(n=8, lattice="sc_curv", nev=4), d1=f["d1"],
        d0=f["d0"], ct=f["ct"], device="cpu", dtype=dtype,
        scale=np.asarray(js.diel.params[0]), solver=solver,
        solver_opts={"warm_maxiter": 0, "doom_check": False}, **kw)
    return js, ts


@pytest.mark.parametrize("solver", ["softlock", "nolock", "descent"])
def test_complex_impl_matches_pcx(solver):
    """``solver_impl="complex"`` runs the complex LOBPCG family
    (``solvers.lobpcg``) through ``KPointSolver``, against the JAX complex
    route from the same numpy start: omega_re to 1e-8, iterations within
    2.  On the CPU both take the FFT (``fft_mode="auto"``)."""
    js, ts = _solvers(solver, impl="complex", solver_impl="complex")
    assert ts.impl == "complex" and ts.dft is None
    x0 = _x0(ts, ALPHA)
    rj = js.solve(ALPHA, x0=jnp.asarray(x0))
    rt = ts.solve(ALPHA, x0=torch.as_tensor(x0))
    assert rt.status == rj.status == Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= 2, (rt.iterations,
                                                      rj.iterations)
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious


def test_fft_mode_fft_matches_matmul():
    """``fft_mode`` picks the DFT of the complex route: ``"fft"``
    (torch.fft) and ``"matmul"`` (the axis-pass DFT) reach the same
    frequencies to 1e-10 in complex128; the pair-layout route keeps the
    matmul DFT whatever the mode, as in JAX."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    omega = {}
    for mode in ("fft", "matmul"):
        kps = KPointSolver(cfg, device="cpu", solver_impl="complex",
                           fft_mode=mode)
        assert (kps.dft is None) is (mode == "fft")
        r = kps.solve(ALPHA, seed=1)
        assert r.status == Status.CONVERGED
        omega[mode] = r.omega_re
    np.testing.assert_allclose(omega["fft"], omega["matmul"], rtol=0,
                               atol=1e-10)
    assert KPointSolver(cfg, device="cpu", fft_mode="fft").dft is not None


def test_refine_false_stats_match_pcx():
    """``refine=False`` validates by the Rayleigh quotients and residuals
    of the solver's own Ritz pairs (pcx ``stats_core``): from the same
    start, the port's report matches the JAX one to 1e-10."""
    js, ts = _solvers(refine=False)
    x0 = _x0(ts, ALPHA)
    rj = js.solve(ALPHA, x0=boundary.encode(x0))
    rt = ts.solve(ALPHA, x0=torch.as_tensor(x0))
    assert rt.status == rj.status == Status.CONVERGED
    assert ts.refine is False
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.omega, rj.omega, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.report.residuals, rj.report.residuals,
                               rtol=1e-6, atol=1e-12)
    rep = ts.validate_solution(ALPHA, rt)
    np.testing.assert_allclose(rep.omega_re, rt.omega_re, rtol=0, atol=0)


def test_coarse_start_matches_pcx():
    """``x0_mode="coarse:6"`` at N=12: the twin solves on the 6-grid, its
    block is lifted to the 12-grid and the fine solve reaches the JAX
    package's coarse-started frequencies to 1e-8
    (tests/test_bandstructure.py:169-181)."""
    alpha = np.array([np.pi, 0.3, 0.0])
    js = jbs.KPointSolver(JaxConfig(n=12, lattice="sc_curv", nev=4),
                          dtype=jnp.complex128, solver_impl="rs",
                          real_boundary=True, refine=False,
                          x0_mode="coarse:6")
    rj = js.solve(alpha, seed=3)
    ts = KPointSolver(ProblemConfig(n=12, lattice="sc_curv", nev=4),
                      device="cpu", x0_mode="coarse:6")
    rt = ts.solve(alpha, seed=3)
    twin = ts._coarse_cache
    assert twin is not None and twin.cfg.n == 6 and twin.refine is False
    assert twin.solver_opts["lam_tol"] == 1e-5
    assert rt.status == rj.status == Status.CONVERGED
    assert 0 < ts.last_x0_wall <= rt.wall_time
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)


def test_coarse_start_falls_back_to_a_random_block(monkeypatch):
    """A coarse solve that ends BLOWUP (or NAN) gives a random start."""
    with pytest.raises(ValueError, match="smaller than n"):
        KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                     device="cpu", x0_mode="coarse")   # max(8, 8 // 2)
    kps = KPointSolver(ProblemConfig(n=12, lattice="sc_curv", nev=4),
                       device="cpu", x0_mode="coarse")
    assert kps._coarse_n == 8      # max(8, n // 2)
    twin = kps._coarse()
    blow = bs.EigenResult(None, None, None, None, 3, 0.0, Status.BLOWUP,
                          None)
    monkeypatch.setattr(twin, "solve", lambda *a, **k: blow)
    x = kps._x0_cold(ALPHA, 8, seed=5)
    ref = bs.maxwell.random_block(kps._generator(5), 12, 8, C128, "cpu")
    assert torch.equal(x, ref)


def test_random_start_matches_plane_wave():
    """``x0_mode="random"`` (uniform real and imaginary parts from the
    port's seeded generator) reaches the plane-wave start's frequencies to
    1e-6, in no fewer iterations (tests/test_bandstructure.py:154-166)."""
    cfg = ProblemConfig(n=10, lattice="sc_curv", nev=6)
    alpha = np.array([np.pi, 0.0, 0.0])
    r_pw = KPointSolver(cfg, device="cpu").solve(alpha, seed=0)
    r_rnd = KPointSolver(cfg, device="cpu", x0_mode="random").solve(
        alpha, seed=0)
    assert r_pw.status == r_rnd.status == Status.CONVERGED
    np.testing.assert_allclose(r_pw.omega_re, r_rnd.omega_re, atol=1e-6)
    assert r_pw.iterations <= r_rnd.iterations


@pytest.mark.parametrize("kw", [
    {"real_boundary": True}, {"real_boundary": False}, {"apply_chunk": 0},
    {"segment_iters": 40}])
def test_tpu_only_keywords_are_refused(kw):
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    with pytest.raises(ValueError, match="Do not port"):
        KPointSolver(cfg, device="cpu", **kw)


@pytest.mark.parametrize("kw,match", [
    ({"x0_mode": "coarse:8"}, "smaller than n"),
    ({"x0_mode": "sobol"}, "x0_mode"),
    ({"fft_mode": "cufft"}, "fft_mode"),
    ({"solver_impl": "pallas"}, "solver_impl"),
    ({"refine": "half"}, "refine"),
    ({"solver_impl": "complex", "solver_opts": {"rr_gram": "pallas"}},
     "rr_gram")])
def test_keyword_values_are_checked(kw, match):
    """Unknown values raise, as in JAX; the complex route refuses the
    pair-layout solver's options (pcx/bandstructure.py:422-432)."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    with pytest.raises(ValueError, match=match):
        KPointSolver(cfg, device="cpu", **kw)


def test_every_pcx_constructor_keyword_is_taken():
    """The port's KPointSolver takes every keyword of the JAX one; the
    entry points run on the card unless asked otherwise."""
    jax_kw = set(inspect.signature(jbs.KPointSolver).parameters)
    port_kw = set(inspect.signature(KPointSolver).parameters)
    assert jax_kw <= port_kw, sorted(jax_kw - port_kw)
    for fn in (KPointSolver, bs.eigen_1p, bs.bandgap):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("gate", ["under-converged", "spurious"])
def test_sweep_escalates_a_light_refine_rejection(tmp_path, monkeypatch,
                                                  capsys, gate):
    """A light refine that rejects a solve (forced here: its residuals
    inflated past the frequency-error bound, or its quotients moved past
    the spurious gate) is re-validated by the complex128 refine, which
    accepts it: the row is committed with that refine's frequencies, and
    the escalation is logged with the JAX package's lines."""
    stats = KPointSolver.refine_light_stats

    def rejecting(self, alpha, x):
        theta, lam_re, res = stats(self, alpha, x)
        if gate == "spurious":
            return theta, lam_re * 1.5, res
        return theta, lam_re, res * 1e6

    monkeypatch.setattr(KPointSolver, "refine_light_stats", rejecting)
    kw = dict(n=8, lattice="sc_flat1", nev=4, gap=4, device="cpu",
              output_dir=str(tmp_path), verbose=False)
    err = bs.bandgap(indices=[2], solver_kw={"refine": "light"}, **kw)
    out = capsys.readouterr().out
    assert err == []
    assert "k=2: light-refine gate failed" in out and gate in out
    assert "k=2: f64 re-validation PASSED" in out
    lib = BandLibrary(str(tmp_path / "chiral" / "bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 16, 4)
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    ref = KPointSolver(cfg, device="cpu", tol=bs.TOL / cfg.scal ** 2).solve(
        bs.lattices.k_path("sc_flat1", gap=4)[2], seed=2)
    np.testing.assert_allclose(lib.frequencies[2], ref.omega_re, atol=1e-8)
    # the complex128 refine does not escalate: the same gate fails the row
    monkeypatch.setattr(KPointSolver, "refine_stats", rejecting)
    err = bs.bandgap(indices=[5], **kw)
    assert err == [5]
    assert "re-validating" not in capsys.readouterr().out


def test_heartbeat_touched_while_solving(tmp_path, monkeypatch):
    """With $PCX_HEARTBEAT set, a solve touches the file at the doom-check
    marks (24, 64, ...) and once at its end, cold or warm."""
    hb = tmp_path / "hb"
    monkeypatch.setenv("PCX_HEARTBEAT", str(hb))
    beats = []
    touch = bs._heartbeat
    monkeypatch.setattr(bs, "_heartbeat", lambda: beats.append(1) or touch())
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    r = KPointSolver(cfg, device="cpu").solve(ALPHA, seed=0)
    assert hb.exists() and r.iterations >= bs.DOOM_FIRST
    assert len(beats) == 2
    monkeypatch.delenv("PCX_HEARTBEAT")
    os.remove(hb)
    bs._heartbeat()
    assert not hb.exists()


def test_library_checks_match_pcx(tmp_path, capsys):
    """``bandgap_wnk_check`` and ``bandgap_history_check`` print and return
    what the JAX package's do, on a committed library and on one with
    failed and pending rows."""
    kw = dict(n=120, lattice="sc_curv", output_dir=os.path.join(ROOT,
                                                               "output_c64"))
    for fn in ("bandgap_wnk_check", "bandgap_history_check"):
        args = dict(kw, indices=[0, 19]) if fn == "bandgap_wnk_check" else kw
        got = getattr(bs, fn)(**args)
        out = capsys.readouterr().out
        ref = getattr(jbs, fn)(**args)
        assert capsys.readouterr().out == out
        assert repr(got) == repr(ref)
    lib = BandLibrary(str(tmp_path / "chiral" / "bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 8, 10)
    lib.record(0, 10, 1.0, np.arange(10) * 0.1)
    lib.record(3, -1, -1, None)
    for mod in (bs, jbs):
        assert mod.bandgap_history_check(8, "sc_flat1",
                                         output_dir=str(tmp_path)) == (
            [3], [1, 2, 4, 5, 6, 7])
        assert mod.bandgap_history_check(8, "fcc",
                                         output_dir=str(tmp_path)) is None
    out = capsys.readouterr().out
    assert out.count("Blow up results detected: [3]") == 2


def test_utils_match_pcx(capsys):
    """``convergence_rate`` against pcx.utils; ``timing`` accumulates;
    ``device_memory_mib`` reads the card's peak (NaN without one)."""
    res = np.exp(-0.3 * np.arange(20)) * (1 + 0.1 * np.sin(np.arange(20)))
    np.testing.assert_allclose(utils.convergence_rate(res, verbose=False),
                               jutils.convergence_rate(res, verbose=False),
                               rtol=1e-12)
    times = {}
    for _ in range(2):
        with utils.timing("step", times, print_time=True) as box:
            sum(range(1000))
    assert times["step"] >= box["elapsed"] > 0
    assert capsys.readouterr().out.count("Runtime of step is") == 2
    mib = utils.device_memory_mib()
    assert (mib >= 0) if torch.cuda.is_available() else np.isnan(mib)


def test_refresh_period_holds_a_cold_near_gamma_solve():
    """ROADMAP F2 at N=16: the cold complex64 solve at sc_curv k_path 0
    (penalty weight 1600) with the JAX refresh period 8 drifts off its
    best point and runs to maxiter with a frequency-error bound the sweep
    refuses (> 2e-3); with ``refresh_period`` (every iteration here) it
    ends FLOOR, well inside the bound.  The period is 8 at |alpha| >= 1
    and shrinks by 4 pi^2 / pnt next to Gamma."""
    assert [bs.refresh_period(p) for p in (bs.PNT_FAR, 44.4, 64.0, 100.0,
                                           400.0, 1600.0)] == [8, 7, 4, 3,
                                                               1, 1]
    cfg = ProblemConfig(n=16, lattice="sc_curv", nev=10)
    alpha = bs.lattices.k_path("sc_curv")[0]
    for opts, status in (({}, Status.FLOOR),
                         ({"refresh_every": 8}, Status.MAXITER)):
        kps = KPointSolver(cfg, device="cpu", dtype=C64, solver_opts=opts)
        r = kps.solve(alpha, seed=0, validate_result=False)
        rep = kps.validate_solution(alpha, r, raise_on_spurious=False)
        bound = np.max(rep.residuals * cfg.scal ** 2 / (
            8 * np.pi ** 2 * np.maximum(rep.omega_re, 0.05)))
        assert r.status == status, (opts, r.status, r.iterations)
        assert bool(bound < 2e-3) is (status == Status.FLOOR), (opts, bound)
