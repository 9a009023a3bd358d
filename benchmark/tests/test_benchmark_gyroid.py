"""The BCC double gyroid's cell: it loads with its metrics, the plain
reference's operator is the program's on the gyroid, and the readers of
the eigensolver's stop and active-column counters."""

import pytest
import torch

from benchmark import chain, harness, lattices, traffic
from benchmark.reference import maxwell

CELL = "bcc_dg_chiral_n120.sweep"
WARM = ("fcc_chiral_n120.sweep", "sc_curv_crossdof_n120.sweep",
        "fcc_chiral_n120.levers", CELL)
NEW = ("stop_floor_share.sweep", "active_cols_per_iter.sweep")


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_loads_with_its_metrics(traced):
    c = harness.cell(CELL, traced)
    assert c.chips == 1 and c.limits["omega_gap"] > 0
    assert c.config["lattice"] == "bcc_dg" and c.config["reduced"] == []
    plan = traffic.plan(c.mix, c.config, 2 ** 31 + 7)
    # the chain and its entry lie strictly inside Gamma (19) -> P (39)
    assert [p.index for p in plan.points] == list(range(24, 32))
    assert plan.entry.index == 23
    names = {m["name"] for m in c.metrics}
    for m in c.metrics:
        assert callable(harness.reader(m["name"]).read)
    if traced:
        fcc = {m["name"] for m in harness.cell(WARM[0], True).metrics}
        assert names == fcc and set(NEW) <= names
    else:
        assert names == {"kpoint_s", "peak_gib", "setup_s"}


def test_the_new_metrics_list_the_warm_chain_cells():
    for name in NEW:
        m = next(m for m in harness.spec()["per_layer"] if m["name"] == name)
        assert tuple(m["workloads"]) == WARM
        assert m["layer"] == "eigensolver" and m["moves"] == "kpoint_s"


def test_the_reference_operator_is_the_program_s_on_the_gyroid():
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.operators import maxwell as pm
    n = 8
    cfg = {"n": n, "lattice": "bcc_dg", "diel_type": "chiral", "eps_opt": 0,
           "nev": 10}
    s = KPointSolver(ProblemConfig(n=n, lattice="bcc_dg", nev=10),
                     device="cpu")
    alpha = lattices.k_path("bcc_dg", 20)[27]
    x = torch.randn((16, 3, n, n, n), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(1))
    sy = s.symbols_for(alpha)
    want = pm.ama_bb(x, sy.d_a, sy.b, s.diel, sy.shift)
    op = maxwell.Operator(cfg, maxwell.Dielectric(cfg, "cpu", cache=False),
                          alpha, "cpu")
    assert float((op.h(x) - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


def _run(iterations=10, points=4):
    from benchmark import trace as tr
    pts = [chain.PointRecord(i, iterations=iterations, ok=True)
           for i in range(points)]
    return harness.Run(points=pts, window_s=2.0, setup_s=9.0, peak_bytes=0,
                       trace=tr.Trace(0, 1, [], []), launches={},
                       k2_by_batch={}, n=120, block_width=16)


def test_the_readers_of_the_stop_and_column_counters(monkeypatch):
    from pcx_torch import tracing
    counts = {"stop.floor": 3, "stop.converged": 1, "stop.maxiter": 0,
              "lobpcg.active_cols": 520, "sync.readback": 44}
    monkeypatch.setattr(tracing, "counts", lambda: dict(counts))
    run = _run()
    assert harness.reader("stop_floor_share").read(run) == \
        pytest.approx(75.0)
    assert harness.reader("active_cols_per_iter").read(run) == \
        pytest.approx(13.0)
    # a program without those counters, or no trace, gives nothing
    monkeypatch.setattr(tracing, "counts", lambda: {"sync.readback": 44})
    for name in ("stop_floor_share", "active_cols_per_iter"):
        assert harness.reader(name).read(run) is None
        assert harness.reader(name).read(run._replace(trace=None)) is None
