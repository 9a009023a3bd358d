"""The port's spans and counters (``pcx_torch.tracing``) on the CPU: the
spans cost nothing but a check while no profiler records, record their
paths inside a solve while one does, and the counters count the same
with or without it."""

import contextlib
import math
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcx_torch import kernels, tracing
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import TYPE_PSEUDO_CROSSDOF, ProblemConfig
from pcx_torch.operators import maxwell
from pcx_torch.solvers import lobpcg_rs
from pcx_torch.solvers.lobpcg import Status
from pcx_torch.solvers.lobpcg_rs import lobpcg_sep_rs
from pcx_torch.utils import generator

ALPHA = np.array([np.pi, 0.0, 0.0])


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.reset()
    yield
    tracing.reset()
    torch.set_num_threads(n)


def _solver(maxiter=4, **kw):
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4, **kw)
    return KPointSolver(cfg, device="cpu", dtype=torch.complex64,
                        maxiter=maxiter, refine="light")


def test_without_a_profiler_a_span_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("pcx.op") is tracing.span("pcx.solve")
    with tracing.span("pcx.op"):
        pass
    assert tracing.totals() == {}
    best = min(timeit.repeat("with span('pcx.op'): pass",
                             globals={"span": tracing.span}, number=20000,
                             repeat=7)) / 20000
    assert best < 1e-6, f"{best * 1e6:.3f} us a span"


def test_spans_nest_into_paths_and_reach_the_profiler():
    solver = _solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solver.solve(ALPHA, raise_on_spurious=False)
    tot = tracing.totals()
    loop = "pcx.solve/pcx.lobpcg"
    for path in (f"{loop}/pcx.op/pcx.diel", f"{loop}/pcx.svqb",
                 f"{loop}/pcx.rr/pcx.eigh", f"{loop}/pcx.step",
                 f"{loop}/pcx.precond", "pcx.solve/pcx.refine",
                 "pcx.solve/pcx.symbols"):
        count, host_ms, device_ms = tot[path]
        assert count > 0 and host_ms > 0 and device_ms > 0, path
    assert tot[f"{loop}/pcx.step"][0] == res.iterations
    assert tot[f"{loop}/pcx.rr"][0] == res.iterations
    # a layer's self time: the solve holds its loop, the loop its steps
    assert tot["pcx.solve"][1] > tot[loop][1] > tot[f"{loop}/pcx.step"][1]
    names = {e.name for e in prof.events()}
    assert {"pcx.solve", "pcx.lobpcg", "pcx.op", "pcx.diel", "pcx.svqb",
            "pcx.rr", "pcx.eigh", "pcx.step", "pcx.refine"} <= names


def _hand_counted_solve(traced: bool, monkeypatch) -> tuple:
    """A capped ``lobpcg_sep_rs`` on the cross-DoF operator whose h_func
    and ``torch.linalg.eigh`` count their own calls and columns; returns
    (hand counts, the program's counters)."""
    solver = _solver(diel_type=TYPE_PSEUDO_CROSSDOF)
    sy = solver.symbols_for(ALPHA)
    hand = {"applies": 0, "columns": 0, "eigh": 0}

    def h_func(v):
        hand["applies"] += 1
        hand["columns"] += v.shape[0]
        return maxwell.ama_bb(v, sy.d_a, sy.b, solver.diel, sy.shift,
                              solver.dft)

    eigh = torch.linalg.eigh

    def counted_eigh(t):
        hand["eigh"] += 1
        return eigh(t)

    x0 = maxwell.random_block(generator(3, solver.device), 8, 6,
                              solver.dtype, solver.device)
    kernels.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(torch.linalg, "eigh", counted_eigh)
        with (profile(activities=[ProfilerActivity.CPU]) if traced
              else contextlib.nullcontext()):
            lobpcg_sep_rs(h_func, lambda v: v, x0, 4, maxiter=5,
                          w_cap="auto")
    return hand, tracing.counts()


def test_counters_are_exact_and_the_same_with_and_without_a_profiler(
        monkeypatch):
    hand, got = _hand_counted_solve(False, monkeypatch)
    assert hand["applies"] > 5 and hand["eigh"] > 10
    assert got["op.applies"] == hand["applies"]
    assert got["op.columns"] == hand["columns"]
    assert got["sync.eigh"] == hand["eigh"]
    assert got["sync.readback"] == 5
    assert not tracing.totals()
    hand_on, got_on = _hand_counted_solve(True, monkeypatch)
    assert hand_on == hand and got_on == got
    assert tracing.totals()


def test_lanes_count_every_lane_column_under_one_solve_span(monkeypatch):
    solver = _solver()
    real, seen = maxwell.ama_bb, []

    def ama_bb(x, *args, **kw):
        seen.append(x.shape[:-4])
        return real(x, *args, **kw)

    monkeypatch.setattr(maxwell, "ama_bb", ama_bb)
    with profile(activities=[ProfilerActivity.CPU]):
        solver.solve_batch([ALPHA, 0.9 * ALPHA], validate_result=False)
    tot, got = tracing.totals(), tracing.counts()
    assert tot["pcx.solve"][0] == 1
    assert "pcx.solve/pcx.lobpcg/pcx.op/pcx.diel" in tot
    assert seen[0][0] == 2          # the lanes fold into one apply
    assert got["op.applies"] == len(seen)
    assert got["op.columns"] == sum(math.prod(s) for s in seen)


def test_reset_launches_clears_the_counters_and_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        _solver().solve(ALPHA, raise_on_spurious=False)
    assert tracing.counts() and tracing.totals()
    kernels.reset_launches()
    assert tracing.counts() == {} and tracing.totals() == {}
    assert set(kernels.launches().values()) == {0}


def test_stop_and_active_column_counters_read_only_the_host(monkeypatch):
    """Two lanes of ``lobpcg_sep_rs_lanes`` on a diagonal operator, one
    stopped by its limit: one ``stop.*`` a lane, by its final status;
    ``lobpcg.active_cols`` the sum of the trackers' active masks; and the
    loop's reads of device values are still its ``sync.readback`` and
    ``sync.result``: the two counters read nothing back."""
    masks = []
    update = lobpcg_rs._Tracker.update

    def tracked(self, it, res, lam):
        st, act = update(self, it, res, lam)
        if st == Status.RUNNING:
            masks.append(act.copy())
        return st, act

    reads = []

    def reading(name):
        real = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads.append(name)
            return real(self, *a, **kw)
        return read

    d = torch.linspace(1.0, 40.0, 300, dtype=torch.float64)
    ops = torch.stack((d, 1.3 * d)).to(torch.complex128)
    x0 = torch.randn((6, 300), dtype=torch.complex128,
                     generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(lobpcg_rs._Tracker, "update", tracked)
    for name in ("cpu", "item", "tolist", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, reading(name))
    out = lobpcg_rs.lobpcg_sep_rs_lanes(
        lambda a, lanes: ops[list(lanes), None] * a, lambda a, lanes: a,
        torch.stack((x0, x0)), 3, tol=1e-8, maxiter=200, limit=[4, None])
    monkeypatch.undo()
    got = tracing.counts()
    stops = {k: v for k, v in got.items() if k.startswith("stop.")}
    assert [r.status for r in out] == [Status.MAXITER, Status.CONVERGED]
    assert stops == {"stop.maxiter": 1, "stop.converged": 1}
    assert got["lobpcg.active_cols"] == int(sum(a.sum() for a in masks))
    assert 0 < got["lobpcg.active_cols"] < 6 * sum(r.iterations for r in out)
    assert len(reads) == got["sync.readback"] + got.get("sync.result", 0)
