"""The reader of ``k7_roofline``: the program's ``k7.bytes`` counter over
the memory rate, over K7's device time by kernel name; nothing from a
program that counts no K7 bytes (one without K7, or a window with the
isotropic eps^{-1}) or a trace without the kernel; and its two entries name
only the two cross-DoF cells."""

import json
import os

import pytest

from benchmark import chain, harness, peaks, trace as tr

K7 = ("void (anonymous namespace)::crossdof_kernel<1>"
      "((anonymous namespace)::Problem)")
K2 = "void (anonymous namespace)::axis_dft_kernel<true>(Params)"
ROLL = ("void at::native::(anonymous namespace)::roll_cuda_kernel"
        "<c10::complex<float> >(c10::complex<float> const*, "
        "c10::complex<float>*, long, long, long, long, long, long)")
TRACE = tr.Trace(start=0, end=1_000_000,
                 device=[(K2, 0, 300_000), (K7, 300_000, 800_000)], host=[])
NBYTES = (48 * 16 + 4 * 5) * 120 ** 3   # one apply at m=16, N=120, pair 12
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(trace=TRACE):
    pts = [chain.PointRecord(i, iterations=10, ok=True) for i in range(2)]
    return harness.Run(points=pts, window_s=1.0, setup_s=9.0, peak_bytes=0,
                       trace=trace, launches={"crossdof_apply": 1},
                       k2_by_batch={}, n=120, block_width=16)


@pytest.fixture
def counted(monkeypatch):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"k7.bytes": NBYTES,
                                                    "op.applies": 1})


def test_k7_is_neither_elementwise_nor_a_copy():
    assert tr.family(K7) == "other"


def test_k7_roofline_is_bytes_over_kernel_time(counted):
    got = harness.reader("k7_roofline").read(_run())
    assert NBYTES == 1_361_664_000
    assert got == pytest.approx(100.0 * NBYTES / peaks.HBM_BYTES_S / 500e-6)


def test_k7_roofline_finds_nothing_without_the_kernel(counted, monkeypatch):
    read = harness.reader("k7_roofline").read
    assert read(_run(trace=None)) is None
    eager = tr.Trace(0, 1_000_000, [(K2, 0, 300_000),
                                    (ROLL, 300_000, 500_000)], [])
    assert read(_run(trace=eager)) is None
    from pcx_torch import tracing
    # the parent, and a window of the isotropic cells: no K7 bytes
    monkeypatch.setattr(tracing, "counts", lambda: {"op.applies": 3})
    assert read(_run()) is None
    monkeypatch.setattr(tracing, "counts", lambda: {})
    assert read(_run()) is None


def test_k7_roofline_entries_name_only_the_cross_dof_cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]
           if m["name"].startswith("k7_roofline")}
    assert set(got) == {"k7_roofline.sweep", "k7_roofline.cold"}
    assert got["k7_roofline.sweep"]["workloads"] == [
        "sc_curv_crossdof_n120.sweep"]
    assert got["k7_roofline.cold"]["workloads"] == [
        "sc_curv_crossdof_n120.cold"]
    assert got["k7_roofline.sweep"]["moves"] == "kpoint_s"
    assert got["k7_roofline.cold"]["moves"] == "cold_solve_s"
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    for m in got.values():
        assert m["layer"] == "dielectric"
        assert all(cells[w] == "sc_curv_crossdof_n120" for w in m["workloads"])
