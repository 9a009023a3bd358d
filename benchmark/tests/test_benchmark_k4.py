"""The reader of ``k4_roofline``: the program's ``k4.bytes`` counter over
the memory rate, over K4's device time by kernel name; nothing from a
program that counts no K4 bytes or a trace without the kernel."""

import pytest

from benchmark import chain, harness, peaks, trace as tr

K4 = ("void (anonymous namespace)::block_combine_kernel<16, true>"
      "((anonymous namespace)::Problem)")
GEMM = "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8"
TRACE = tr.Trace(start=0, end=1_000_000,
                 device=[(K4, 0, 300_000), (GEMM, 300_000, 500_000),
                         (K4, 600_000, 700_000)], host=[])
NBYTES = 3 * 3_317_760_000    # three Rayleigh-Ritz updates at m=16, N=120


def _run(trace=TRACE):
    pts = [chain.PointRecord(i, iterations=10, ok=True) for i in range(2)]
    return harness.Run(points=pts, window_s=1.0, setup_s=9.0, peak_bytes=0,
                       trace=trace, launches={"block_combine": 3},
                       k2_by_batch={}, n=120, block_width=16)


@pytest.fixture
def counted(monkeypatch):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"k4.bytes": NBYTES,
                                                    "dense.k4": 3})


def test_k4_is_no_gemm():
    assert tr.family(K4) == "other"


def test_k4_roofline_is_bytes_over_kernel_time(counted):
    got = harness.reader("k4_roofline").read(_run())
    assert got == pytest.approx(100.0 * NBYTES / peaks.HBM_BYTES_S / 400e-6)


def test_k4_roofline_finds_nothing_without_the_kernel(counted, monkeypatch):
    read = harness.reader("k4_roofline").read
    assert read(_run(trace=None)) is None
    gemm_only = tr.Trace(0, 1_000_000, [(GEMM, 0, 500_000)], [])
    assert read(_run(trace=gemm_only)) is None
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"dense.matmul": 3})
    assert read(_run()) is None
