"""The SC-CURV chiral N=150 cell: it loads with its metrics, and the reader
of K2's resident blocks per SM."""

import pytest

from benchmark import chain, harness, traffic

CELL = "sc_curv_chiral_n150.cold"
COLD = ("sc_curv_crossdof_n120.cold", CELL)
NEW = "k2_blocks_per_sm.cold"


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_loads_with_its_metrics(traced):
    c = harness.cell(CELL, traced)
    assert c.chips == 1 and c.limits["omega_gap"] > 0
    assert (c.config["lattice"], c.config["diel_type"], c.config["n"]) == \
        ("sc_curv", "chiral", 150)
    assert c.config["reduced"] == []
    plan = traffic.plan(c.mix, c.config, 2 ** 31 + 11)
    assert sorted(p.index for p in plan.points) == [19, 29, 39, 59]
    assert plan.entry is None and plan.check_per_pass == 4
    names = {m["name"] for m in c.metrics}
    for m in c.metrics:
        assert callable(harness.reader(m["name"]).read)
    cold = {m["name"] for m in harness.cell(COLD[0], traced).metrics}
    assert names == cold
    if traced:
        assert NEW in names and "k2_roofline.cold" in names
        assert all(n.endswith(".cold") for n in names)
    else:
        assert names == {"cold_solve_s", "peak_gib", "setup_s"}


def test_the_new_metric_lists_the_two_cold_cells():
    m = next(m for m in harness.spec()["per_layer"] if m["name"] == NEW)
    assert tuple(m["workloads"]) == COLD
    assert (m["layer"], m["moves"], m["unit"], m["better"], m["source"]) == \
        ("kernel K2", "cold_solve_s", "blocks", "higher", "program_counter")


def _run(k2_by_batch, n=150):
    from benchmark import trace as tr
    pts = [chain.PointRecord(i, iterations=60, ok=True) for i in range(4)]
    return harness.Run(points=pts, window_s=12.0, setup_s=30.0,
                       peak_bytes=0, trace=tr.Trace(0, 1, [], []),
                       launches={}, k2_by_batch=k2_by_batch, n=n,
                       block_width=16)


@pytest.mark.parametrize("blocks, want", [(1, 1.0), (2, 2.0)])
def test_the_reader_of_k2_blocks_per_sm(blocks, want, monkeypatch):
    from pcx_torch import tracing
    by_batch = {48: 700, 12: 35, 3: 4}
    counts = {"k2.sm_blocks": blocks * sum(by_batch.values()),
              "sync.readback": 44}
    monkeypatch.setattr(tracing, "counts", lambda: dict(counts))
    run = _run(by_batch)
    assert harness.reader(NEW).read(run) == pytest.approx(want)
    # untraced, nothing is read
    assert harness.reader(NEW).read(run._replace(trace=None)) is None


def test_a_program_without_the_counter_gives_nothing(monkeypatch):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"sync.readback": 44})
    assert harness.reader(NEW).read(_run({48: 700})) is None
    monkeypatch.setattr(tracing, "counts", lambda: {})
    assert harness.reader(NEW).read(_run({})) is None
