"""The FCC preset-1 cross-DoF cell and fcc's ``rr_gram="pallas"`` cell:
they load with their metrics, and the readers of K7's i-axis instances and
of K3 against their bounds."""

import pytest

from benchmark import chain, harness, peaks, traffic
from benchmark import trace as tr

CROSS, PALLAS = "fcc_crossdof1_n120.sweep", "fcc_chiral_n120.pallas"
NEW = {CROSS: "k7_iaxis_roofline.sweep", PALLAS: "k3_roofline.sweep"}
# the warm cells' lists these cells are not on (tests of the gyroid and K7
# cells pin them)
PINNED = {"stop_floor_share.sweep", "active_cols_per_iter.sweep",
          "k7_roofline.sweep"}

K7 = ("void (anonymous namespace)::crossdof_kernel<1, 2>"
      "((anonymous namespace)::Problem)")
K3 = ("void (anonymous namespace)::gram9_partial_kernel<true>"
      "((anonymous namespace)::Stack, (anonymous namespace)::Stack, "
      "float2*, int, long long, int, long long)")
K3_SUM = ("(anonymous namespace)::gram9_reduce_kernel(float2 const*, "
          "double2*, int, int)")
K2 = "void (anonymous namespace)::axis_dft_kernel<true>(Params)"
K7_BYTES = (48 * 16 + 4 * 5) * 120 ** 3     # one apply at m=16, N=120
K3_BYTES = 8 * (6 * 16 * 3 * 120 ** 3 + 2 * 2532 * 48 ** 2)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", [CROSS, PALLAS])
def test_the_cells_load_with_their_metrics(name, traced):
    c = harness.cell(name, traced)
    assert c.chips == 1 and c.limits["omega_gap"] > 0
    assert c.config["n"] == 120 and c.config["reduced"] == []
    want = ("pseudochiral_crossdof", 1) if name == CROSS else ("chiral", 0)
    assert (c.config["lattice"], c.config["diel_type"],
            c.config["eps_opt"]) == ("fcc",) + want
    plan = traffic.plan(c.mix, c.config, 2 ** 31 + 25)
    assert [p.index for p in plan.points] == list(range(10, 18))
    assert plan.entry.index == 9 and plan.check_per_pass == 2
    names = {m["name"] for m in c.metrics}
    for m in c.metrics:
        assert callable(harness.reader(m["name"]).read)
    if traced:
        fcc = {m["name"] for m in
               harness.cell("fcc_chiral_n120.sweep", True).metrics}
        assert names == (fcc - PINNED) | {NEW[name]}
    else:
        assert names == {"kpoint_s", "peak_gib", "setup_s"}


def test_the_pallas_mix_is_the_warm_chain_with_the_k3_route():
    warm, pallas = (traffic.load(n) for n in ("warm_chain.10-17",
                                              "warm_chain_pallas.10-17"))
    assert pallas["solver_opts"] == {"rr_gram": "pallas"}
    assert warm["solver_opts"] == {}
    assert {k: v for k, v in pallas.items() if k != "solver_opts"} == \
        {k: v for k, v in warm.items() if k != "solver_opts"}
    c = harness.cell(PALLAS, False)
    assert harness.cell("fcc_chiral_n120.sweep", False).config == c.config


@pytest.mark.parametrize("name", [CROSS, PALLAS])
def test_each_new_metric_lists_exactly_its_cell(name):
    m = next(m for m in harness.spec()["per_layer"] if m["name"] == NEW[name])
    assert m["workloads"] == [name]
    layer = "dielectric" if name == CROSS else "dense algebra"
    assert (m["layer"], m["moves"], m["unit"], m["better"], m["source"]) == \
        (layer, "kpoint_s", "%", "higher", "device_trace")


def _run(trace):
    pts = [chain.PointRecord(i, iterations=40, ok=True) for i in range(8)]
    return harness.Run(points=pts, window_s=12.0, setup_s=15.0,
                       peak_bytes=0, trace=trace, launches={},
                       k2_by_batch={}, n=120, block_width=16)


TRACE = tr.Trace(start=0, end=1_000_000,
                 device=[(K2, 0, 100_000), (K7, 100_000, 600_000),
                         (K3, 600_000, 880_000), (K3_SUM, 880_000, 900_000)],
                 host=[])


def _counts(monkeypatch, counts):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: dict(counts))


def test_k7_iaxis_roofline_is_its_bytes_over_k7_time(monkeypatch):
    read = harness.reader("k7_iaxis_roofline").read
    _counts(monkeypatch, {"k7.bytes": K7_BYTES, "k7.iaxis_bytes": K7_BYTES})
    assert read(_run(TRACE)) == pytest.approx(
        100.0 * K7_BYTES / peaks.HBM_BYTES_S / 500e-6)
    assert read(_run(None)) is None


@pytest.mark.parametrize("counts", [
    {"k7.bytes": K7_BYTES},                              # pair 12 alone
    {"k7.bytes": 2 * K7_BYTES, "k7.iaxis_bytes": K7_BYTES},  # both kinds
    {"op.applies": 3},                                   # no K7
    {}],
    ids=["pair-12", "mixed", "no-k7", "nothing"])
def test_k7_iaxis_roofline_finds_nothing_unless_every_launch_is_i_axis(
        counts, monkeypatch):
    _counts(monkeypatch, counts)
    assert harness.reader("k7_iaxis_roofline").read(_run(TRACE)) is None


def test_k3_roofline_is_its_bytes_over_both_kernels(monkeypatch):
    read = harness.reader("k3_roofline").read
    _counts(monkeypatch, {"k3.bytes": K3_BYTES, "gram.bytes": 1})
    assert K3_BYTES == 4_074_651_648
    assert read(_run(TRACE)) == pytest.approx(
        100.0 * K3_BYTES / peaks.HBM_BYTES_S / 300e-6)
    assert read(_run(None)) is None
    no_k3 = tr.Trace(0, 1_000_000, [(K2, 0, 100_000)], [])
    assert read(_run(no_k3)) is None


@pytest.mark.parametrize("counts", [{"gram.bytes": 1}, {}],
                         ids=["xla-route", "nothing"])
def test_k3_roofline_finds_nothing_without_its_counter(counts, monkeypatch):
    _counts(monkeypatch, counts)
    assert harness.reader("k3_roofline").read(_run(TRACE)) is None
