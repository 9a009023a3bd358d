"""The readers of the program's spans and counters, on a synthetic window
and a filled registry of ``pcx_torch.tracing``; a program without that
module gives nothing."""

import sys

import pytest

from benchmark import chain, harness, trace as tr

READERS = ("op_ms_per_iter", "diel_ms_per_iter", "dense_ms_per_iter",
           "refine_share", "syncs_per_iter", "op_cols_per_iter",
           "step_idle_ms_per_iter")
LOOP = "pcx.solve/pcx.lobpcg"
# {path: (count, host ms, device ms)} of a 2 s window of 40 iterations
TOTALS = {
    "pcx.solve": (4, 1900.0, 1890.0),
    LOOP: (4, 1800.0, 1790.0),
    f"{LOOP}/pcx.op": (44, 300.0, 400.0),
    f"{LOOP}/pcx.op/pcx.diel": (44, 10.0, 120.0),
    f"{LOOP}/pcx.svqb": (80, 600.0, 500.0),
    f"{LOOP}/pcx.svqb/pcx.eigh": (80, 100.0, 60.0),
    f"{LOOP}/pcx.rr": (40, 700.0, 700.0),
    f"{LOOP}/pcx.rr/pcx.eigh": (40, 50.0, 30.0),
    f"{LOOP}/pcx.step": (40, 80.0, 40.0),
    "pcx.solve/pcx.refine": (4, 30.0, 28.0),
    "pcx.solve/pcx.refine/pcx.op": (8, 20.0, 25.0),
    "pcx.refine": (1, 10.0, 9.0),
}
COUNTS = {"op.applies": 52, "op.columns": 832, "sync.readback": 40,
          "sync.upload": 48, "sync.eigh": 130, "sync.result": 4,
          "sync.refine": 15, "sync.doom": 3}
K = "void resid_precond_kernel(float2 const*)"
# device busy 0-100 and 300-1000 us, idle 100-300 (a pcx.step at 150-260
# holds its midpoint) and 1000-1200 (its midpoint in no step)
TRACE = tr.Trace(start=0, end=1_200_000,
                 device=[(K, 0, 100_000), (K, 300_000, 1_000_000)],
                 host=[("pcx.step", 150_000, 260_000),
                       ("aten::copy_", 160_000, 250_000),
                       ("pcx.step", 1_150_000, 1_160_000),
                       ("pcx.rr", 1_000_000, 1_140_000)])


def _run(trace=TRACE, iterations=10, points=4):
    pts = [chain.PointRecord(i, iterations=iterations, ok=True)
           for i in range(points)]
    return harness.Run(points=pts, window_s=2.0, setup_s=9.0, peak_bytes=0,
                       trace=trace, launches={}, k2_by_batch={}, n=120,
                       block_width=16)


@pytest.fixture
def filled(monkeypatch):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "totals", lambda: dict(TOTALS))
    monkeypatch.setattr(tracing, "counts", lambda: dict(COUNTS))


def _read(name, run):
    return harness.reader(name).read(run)


def test_span_readers_take_the_loop_s_paths(filled):
    run = _run()
    assert _read("op_ms_per_iter", run) == pytest.approx(400.0 / 40)
    assert _read("diel_ms_per_iter", run) == pytest.approx(120.0 / 40)
    assert _read("dense_ms_per_iter", run) == pytest.approx(1200.0 / 40)
    assert _read("refine_share", run) == pytest.approx(100 * 40.0 / 2000)


def test_counter_readers_divide_by_iterations(filled):
    run = _run()
    assert _read("syncs_per_iter", run) == pytest.approx(240 / 40)
    assert _read("op_cols_per_iter", run) == pytest.approx(832 / 40)


def test_step_idle_counts_only_gaps_whose_midpoint_is_in_a_step():
    assert _read("step_idle_ms_per_iter", _run()) == pytest.approx(
        0.2 / 40)
    moved = TRACE._replace(host=[("pcx.step", 210_000, 260_000)])
    assert _read("step_idle_ms_per_iter", _run(moved)) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_trace_iterations_or_the_module(name, filled,
                                                          monkeypatch):
    assert _read(name, _run(trace=None)) is None
    assert _read(name, _run(iterations=0)) is None
    if name != "step_idle_ms_per_iter":
        # a program without the tracing module
        import pcx_torch
        monkeypatch.delattr(pcx_torch, "tracing")
        monkeypatch.setitem(sys.modules, "pcx_torch.tracing", None)
        assert _read(name, _run()) is None


def test_step_idle_needs_steps_and_device_events():
    assert _read("step_idle_ms_per_iter",
                 _run(TRACE._replace(host=[]))) is None
    assert _read("step_idle_ms_per_iter",
                 _run(TRACE._replace(device=[]))) is None
