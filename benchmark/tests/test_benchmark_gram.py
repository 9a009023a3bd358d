"""The reader of ``gram_roofline``: the program's ``gram.bytes`` counter
over the memory rate, over kernel K6's device time by kernel name (both of
its passes); nothing from a program that counts no K6 bytes or a trace
without the kernel."""

import pytest

from benchmark import chain, harness, peaks, trace as tr

CHUNKS = ("void (anonymous namespace)::gram_chunks_kernel<3, 3, 16, 16>"
          "((anonymous namespace)::Problem)")
FOLD = "void (anonymous namespace)::gram_fold_kernel<false>(double2 const*, "\
       "void*, long long, int, int)"
K4 = ("void (anonymous namespace)::block_combine_kernel<16, true>"
      "((anonymous namespace)::Problem)")
TRACE = tr.Trace(start=0, end=1_000_000,
                 device=[(CHUNKS, 0, 400_000), (FOLD, 400_000, 410_000),
                         (K4, 410_000, 700_000)], host=[])
NBYTES = 8 * 3 * 120 ** 3 * 96 + 32 * 528 * 48 * 48   # the six-block Gram


def _run(trace=TRACE):
    pts = [chain.PointRecord(i, iterations=10, ok=True) for i in range(2)]
    return harness.Run(points=pts, window_s=1.0, setup_s=9.0, peak_bytes=0,
                       trace=trace, launches={"gram_chunks": 1},
                       k2_by_batch={}, n=120, block_width=16)


@pytest.fixture
def counted(monkeypatch):
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"gram.bytes": NBYTES,
                                                    "dense.gram": 1})


def test_k6_is_no_gemm_reduction_or_k3():
    assert tr.family(CHUNKS) == tr.family(FOLD) == "other"


def test_gram_roofline_is_bytes_over_both_passes(counted):
    got = harness.reader("gram_roofline").read(_run())
    assert got == pytest.approx(100.0 * NBYTES / peaks.HBM_BYTES_S / 410e-6)


def test_gram_roofline_finds_nothing_without_the_kernel(counted,
                                                         monkeypatch):
    read = harness.reader("gram_roofline").read
    assert read(_run(trace=None)) is None
    k4_only = tr.Trace(0, 1_000_000, [(K4, 0, 500_000)], [])
    assert read(_run(trace=k4_only)) is None
    from pcx_torch import tracing
    monkeypatch.setattr(tracing, "counts", lambda: {"dense.gram": 3})
    assert read(_run()) is None
