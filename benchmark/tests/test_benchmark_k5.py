"""The reader of ``k5_roofline``: the program's ``k5.bytes`` counter over
the memory rate, over K5's device time by kernel name; nothing from a
program that counts no K5 bytes or a trace without the kernel."""

import pytest

from benchmark import chain, harness, peaks, trace as tr

PRE = ("void (anonymous namespace)::op_blocks_kernel<0, 2>"
       "((anonymous namespace)::Problem)")
POST = ("void (anonymous namespace)::op_blocks_kernel<2, 2>"
        "((anonymous namespace)::Problem)")
K2 = "void (anonymous namespace)::axis_dft_kernel<true>(Params)"
TRACE = tr.Trace(start=0, end=1_000_000,
                 device=[(PRE, 0, 200_000), (K2, 200_000, 500_000),
                         (POST, 500_000, 800_000)], host=[])
V = 24 * 120 ** 3
NBYTES = 33 * V + 50.5 * V      # one apply's two passes at m=16, N=120


def _run(trace=TRACE):
    pts = [chain.PointRecord(i, iterations=10, ok=True) for i in range(2)]
    return harness.Run(points=pts, window_s=1.0, setup_s=9.0, peak_bytes=0,
                       trace=trace, launches={"op_pre": 1, "op_post": 1},
                       k2_by_batch={}, n=120, block_width=16)


@pytest.fixture
def counted(monkeypatch):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"k5.bytes": NBYTES,
                                                    "op.applies": 1})


def test_k5_is_neither_elementwise_nor_a_copy():
    assert tr.family(PRE) == tr.family(POST) == "other"


def test_k5_roofline_is_bytes_over_kernel_time(counted):
    got = harness.reader("k5_roofline").read(_run())
    assert got == pytest.approx(100.0 * NBYTES / peaks.HBM_BYTES_S / 500e-6)


def test_k5_roofline_finds_nothing_without_the_kernel(counted, monkeypatch):
    read = harness.reader("k5_roofline").read
    assert read(_run(trace=None)) is None
    k2_only = tr.Trace(0, 1_000_000, [(K2, 0, 500_000)], [])
    assert read(_run(trace=k2_only)) is None
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"op.applies": 3})
    assert read(_run()) is None
