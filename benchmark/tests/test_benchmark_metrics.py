"""The reduction of a trace and the metric readers, on a synthetic window;
the byte counts of the roofline readers pinned to the kernels' figures."""

import pytest

from benchmark import chain, harness, peaks, trace as tr

K2 = "void (anonymous namespace)::axis_dft_kernel<true>(CUtensorMap_st)"
K1 = "void resid_precond_kernel(float2 const*)"
GEMM = "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8"
ADD = "void at::native::vectorized_elementwise_kernel<2, add>"

# a 1000 us window: device busy 100-400 (two overlapping kernels), 500-600
# and 700-950; the host spends 400-500 in a sync inside an eigh
TRACE = tr.Trace(
    start=0, end=1_000_000,
    device=[(GEMM, 100_000, 300_000), (ADD, 200_000, 400_000),
            (K2, 500_000, 600_000), (K1, 700_000, 950_000)],
    host=[("aten::linalg_eigh", 380_000, 520_000),
          ("cudaStreamSynchronize", 410_000, 490_000),
          ("aten::mul", 650_000, 660_000)])


def _run(points, trace=TRACE, **kw):
    base = dict(points=points, window_s=2.0, setup_s=9.0,
                peak_bytes=3 * 2 ** 30, trace=trace,
                launches={"resid_precond": 2, "axis_dft": 3},
                k2_by_batch={48: 2, 30: 1}, n=120, block_width=16)
    base.update(kw)
    return harness.Run(**base)


def _points():
    pts = [chain.PointRecord(i, iterations=10, ok=True) for i in range(4)]
    pts[1].escalated = True
    pts[2].retried, pts[2].iterations = True, 30
    return pts


def test_union_gaps_and_busy_count_overlap_once():
    assert tr.union(TRACE) == [[100_000, 400_000], [500_000, 600_000],
                               [700_000, 950_000]]
    assert tr.gaps(TRACE) == [(0, 100_000), (400_000, 500_000),
                              (600_000, 700_000), (950_000, 1_000_000)]
    assert tr.busy_s(TRACE) == pytest.approx(650e-6)
    assert tr.window_s(TRACE) == pytest.approx(1e-3)


def test_families_and_named_kernels():
    fam = tr.device_s(TRACE)
    assert fam["cuBLAS GEMMs"] == pytest.approx(200e-6)
    assert fam["eager elementwise"] == pytest.approx(200e-6)
    assert fam["K2 axis_dft"] == pytest.approx(100e-6)
    assert fam["K1 resid_precond"] == pytest.approx(250e-6)
    assert tr.device_s(TRACE, ("axis_dft_kernel",)) == {
        "total": pytest.approx(100e-6)}


def test_breakdown_names_gaps_by_the_host_operation():
    bd = tr.breakdown(TRACE)
    assert bd["device_ops"][0] == [K1, pytest.approx(250e-6)]
    idle = dict(bd["idle_gaps"])
    assert idle["aten::linalg_eigh | cudaStreamSynchronize"] == \
        pytest.approx(100e-6)
    assert idle["aten::mul"] == pytest.approx(100e-6)
    assert idle["host outside any operation"] == pytest.approx(150e-6)


def test_readers_divide_by_points_and_iterations():
    run = _run(_points())
    read = {name: harness.reader(name).read(run) for name in (
        "kpoint_s", "cold_solve_s", "peak_gib", "setup_s", "retry_share",
        "ms_per_iter", "iters_per_kpoint", "iters_per_solve",
        "gemm_ms_per_iter", "eltwise_ms_per_iter", "device_idle")}
    assert read["kpoint_s"] == read["cold_solve_s"] == pytest.approx(0.5)
    assert read["peak_gib"] == pytest.approx(3.0)
    assert read["setup_s"] == 9.0
    assert read["retry_share"] == pytest.approx(50.0)
    assert read["ms_per_iter"] == pytest.approx(2000.0 / 60)
    assert read["iters_per_kpoint"] == read["iters_per_solve"] == 15.0
    assert read["gemm_ms_per_iter"] == pytest.approx(0.2 / 60)
    assert read["eltwise_ms_per_iter"] == pytest.approx(0.2 / 60)
    assert read["device_idle"] == pytest.approx(35.0)


def test_readers_find_nothing_without_a_trace_or_launches():
    run = _run(_points(), trace=None)
    for name in ("gemm_ms_per_iter", "eltwise_ms_per_iter", "device_idle",
                 "k1_roofline", "k2_roofline"):
        assert harness.reader(name).read(run) is None
    run = _run(_points(), launches={}, k2_by_batch={})
    assert harness.reader("k1_roofline").read(run) is None
    assert harness.reader("k2_roofline").read(run) is None
    cpu = tr.Trace(0, 10, [], [("aten::mul", 0, 10)])
    assert harness.reader("device_idle").read(_run(_points(), cpu)) is None


def test_byte_counts_are_the_kernels_figures():
    k1, k2 = harness.reader("k1_roofline"), harness.reader("k2_roofline")
    # chip_smoke.py phase 4: K2 moves 16 B N^3 bytes a pass, 1.327 GB at
    # B=48, N=120; phase 3: K1 moves 2.05 GB at m=16, N=120
    assert k2.pass_bytes(48, 120) == 1_327_104_000
    assert k1.call_bytes(16, 120) == 2_052_864_128
    assert k1.call_flops(16, 120) / peaks.F32_FLOPS < \
        k1.call_bytes(16, 120) / peaks.HBM_BYTES_S


def test_rooflines_from_launches_and_kernel_time():
    run = _run(_points())
    k2 = harness.reader("k2_roofline")
    want = 100.0 * (2 * k2.pass_bytes(48, 120) + k2.pass_bytes(30, 120)) \
        / peaks.HBM_BYTES_S / 100e-6
    assert k2.read(run) == pytest.approx(want)
    k1 = harness.reader("k1_roofline")
    want = 100.0 * 2 * k1.call_bytes(16, 120) / peaks.HBM_BYTES_S / 250e-6
    assert k1.read(run) == pytest.approx(want)
