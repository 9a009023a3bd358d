"""The solver variants of ``KPointSolver(solver=)`` that run other
algorithms or another preconditioner than the production LOBPCG, against
the JAX package on identical numpy state: ``"davidson"`` and ``"jd"``
against the JAX complex route, ``"mixed"`` (bfloat16 preconditioner)
against the JAX pair-layout route; the solver_opts each refuses and
ignores; and K1's hook off for ``"mixed"`` in complex64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import boundary
from pcx.bandstructure import KPointSolver as JaxSolver
from pcx.config import ProblemConfig as JaxConfig
from pcx_torch import bandstructure as bs
from pcx_torch import interop
from pcx_torch.bandstructure import KPointSolver, eigen_1p
from pcx_torch.config import ProblemConfig
from pcx_torch.solvers.lobpcg import Status
from test_torch_solver import _pair_solvers, _x0

# Every parallel test worker imports this file: two intra-op threads each.
torch.set_num_threads(min(torch.get_num_threads(), 2))

ALPHA = np.array([np.pi, 0.2, 0.0])
C128 = torch.complex128


def _both(js, ts, x0):
    rj = js.solve(ALPHA, x0=boundary.encode(x0))
    rt = ts.solve(ALPHA, x0=interop.block(x0, C128, "cpu"))
    return rj, rt


@pytest.mark.parametrize("solver,opts", [("davidson", {}),
                                         ("jd", {"subspace": 24})])
def test_davidson_and_jd_solves_match_pcx(solver, opts):
    """Davidson (default capacity 40: it restarts every few iterations)
    and Jacobi-Davidson (capacity 24) through ``KPointSolver`` against the
    JAX complex route from the same start: omega_re to 1e-8, iterations
    within 2."""
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex128, C128,
                           jax_kw={"solver_opts": dict(opts)},
                           torch_opts=dict(opts), impl="complex",
                           solver=solver)
    rj, rt = _both(js, ts, _x0(ts, ALPHA))
    assert rt.status == rj.status == Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= 2, (rt.iterations,
                                                      rj.iterations)
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious


def test_mixed_solve_matches_pcx():
    """``solver="mixed"`` (the preconditioner in bfloat16 on real and
    imaginary planes) against the JAX pair-layout route: XLA may carry a
    bfloat16 chain in float32 where torch rounds every operation, so the
    iterations are bounded (within 3), not the bits; omega_re to 1e-8."""
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex128, C128,
                           solver="mixed")
    rj, rt = _both(js, ts, _x0(ts, ALPHA))
    assert rt.status == rj.status == Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= 3, (rt.iterations,
                                                      rj.iterations)
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious


def test_mixed_complex64_runs_the_plain_preconditioner(monkeypatch):
    """In complex64 the production solver takes K1's fused residual/
    preconditioner hook; ``"mixed"`` does not (K1 computes the
    preconditioner in float32) and runs its bfloat16 ``h_block``."""
    k1_calls, plane_dtypes = [], []
    k1, planes = bs.resid_precond, bs.h_block_planes

    def counting_k1(*args):
        k1_calls.append(1)
        return k1(*args)

    def recording_planes(xr, *args):
        plane_dtypes.append(xr.dtype)
        return planes(xr, *args)

    monkeypatch.setattr(bs, "resid_precond", counting_k1)
    monkeypatch.setattr(bs, "h_block_planes", recording_planes)
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.0, 0.0])
    omega = {}
    for solver in ("softlock", "mixed"):
        k1_calls.clear()
        plane_dtypes.clear()
        r = KPointSolver(cfg, device="cpu", dtype=torch.complex64, tol=1e-5,
                         solver=solver).solve(alpha, seed=0)
        assert r.status in (Status.CONVERGED, Status.FLOOR)
        assert r.x.dtype == torch.complex64
        assert bool(k1_calls) is (solver == "softlock")
        assert set(plane_dtypes) == ({torch.bfloat16} if solver == "mixed"
                                     else set())
        omega[solver] = r.omega_re
    # complex64 iterates: frequencies to 5e-5 (tests/test_pallas.py:160)
    np.testing.assert_allclose(omega["mixed"], omega["softlock"], atol=5e-5)


def test_davidson_solver_opts_refused_and_ignored_as_in_pcx():
    """Davidson/JD refuse the keys that the JAX complex route refuses
    (``rr_gram`` here) and ignore the other LOBPCG keys
    (``ortho_passes``); ``subspace`` is theirs alone."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    kw = dict(device="cpu", dtype=C128)
    with pytest.raises(ValueError, match="rr_gram"):
        KPointSolver(cfg, solver="davidson", solver_opts={"rr_gram": "pallas"},
                     **kw)
    js = JaxSolver(JaxConfig(n=8, lattice="sc_curv", nev=4),
                   dtype=jnp.complex128, solver="davidson",
                   solver_impl="complex", solver_opts={"rr_gram": "pallas"})
    with pytest.raises(ValueError, match="rr_gram"):
        js.solve(ALPHA)
    with pytest.raises(ValueError, match="subspace"):
        KPointSolver(cfg, solver="softlock", solver_opts={"subspace": 24},
                     **kw)
    base = KPointSolver(cfg, solver="jd", **kw).solve(ALPHA, seed=1)
    same = KPointSolver(cfg, solver="jd", solver_opts={"ortho_passes": 1},
                        **kw).solve(ALPHA, seed=1)
    assert base.status == same.status == Status.CONVERGED
    assert base.iterations == same.iterations
    np.testing.assert_array_equal(base.omega_re, same.omega_re)


@pytest.mark.parametrize("solver", ["mixed", "davidson", "jd"])
def test_eigen_1p_runs_every_new_variant(solver):
    """``eigen_1p(solver=)`` reaches the same frequencies as the
    production solver."""
    alpha = np.array([np.pi, 0.0, 0.0])
    base = eigen_1p(8, "sc_curv", alpha, device="cpu", nev=4, verbose=False)
    res = eigen_1p(8, "sc_curv", alpha, device="cpu", nev=4, verbose=False,
                   solver=solver)
    assert res.status == Status.CONVERGED
    assert not res.report.spurious
    np.testing.assert_allclose(res.omega_re, base.omega_re, atol=1e-6)
