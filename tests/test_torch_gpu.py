"""The port's CUDA kernels against their plain PyTorch versions, a small
complex64 solve and sweep through the kernels against the same on the CPU,
a complex128 sweep on the card against a committed library, and the
Hermitian-tensor dielectrics on the card (complex64 against complex128
applies, a complex128 cross-DoF sweep against the CPU's), the Davidson
and ``"mixed"`` solver variants on the card against the CPU, the light
refine against the complex128 refine, the two-grid lift ``resample3``
against the CPU's, the complex route's two DFTs, and kernel K4 (the dense
algebra's block combinations) and kernel K5 (the operator's block
multiplies around K2) against their plain versions and complex128 and on
the solvers' paths, and kernel K6 (the dense algebra's Grams) against
complex128 and the cuBLAS route, and on the solvers' paths.

Every test here needs a CUDA device and skips without one (the kernels have
no interpret mode).  The file imports torch and pcx_torch only, so it runs
where JAX is not installed; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from pcx_torch import bandstructure as bs
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.kernels import axis_dft, block_combine, gram9, resid_precond
from pcx_torch.kernels.axis_dft import axis_dft_plain, dft_matrix
from pcx_torch.kernels.block_combine import block_combine_plain
from pcx_torch.kernels.gram9 import gram9_plain
from pcx_torch.kernels.resid_precond import resid_precond_plain
from pcx_torch.operators import dielectric
from pcx_torch.operators import symbols as sym
from pcx_torch.operators.dft import dft3, dft_mats, resample3, upsample_mat
from pcx_torch.solvers import rayleigh_ritz as rr

pytestmark = pytest.mark.gpu
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda", 0)


def test_k1_cuda_matches_plain():
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m, d = 16, 120 ** 3 + 37     # ragged tail of the last block
    c = lambda *s: torch.randn(s, generator=gen, device=dev,
                               dtype=torch.complex64)
    args = (c(m, 3, d), c(m, 3, d),
            torch.rand((m,), generator=gen, device=dev) * 100,
            torch.rand((3, d), generator=gen, device=dev), 0.1 * c(3, d))
    n0 = resid_precond.launches
    w, ss = resid_precond(*args)
    w_p, ss_p = resid_precond_plain(*args)
    torch.cuda.synchronize()
    assert resid_precond.launches == n0 + 1
    # f32 on both sides, another summation order for the column sums
    torch.testing.assert_close(w, w_p, rtol=1e-5,
                               atol=1e-6 * float(w_p.abs().max()))
    torch.testing.assert_close(ss, ss_p, rtol=1e-5, atol=0.0)


# N=75 has an odd K: the kernel loads with cp.async there (TMA needs 16-byte
# row strides); B=5 is not a multiple of 3 (the solver's 3 m).
K2_NS = [16, 50, 75, 100, 120, 150]


def _k2_input(n, seed, b=5, shape=None):
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape or (b, n, n, n), generator=gen, device=dev,
                       dtype=torch.complex64)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", K2_NS)
def test_k2_cuda_matches_plain(n, inverse):
    x = _k2_input(n, 1)
    n0 = axis_dft.launches
    y = axis_dft(x, inverse)
    y_p = axis_dft_plain(x, dft_matrix(n, inverse, x.device))
    torch.cuda.synchronize()
    assert axis_dft.launches == n0 + 1
    # the FFT's f32 rounding vs the einsum's f32 GEMM: 5e-6 of the output
    # scale (single-pass TF32 would show ~1e-3)
    torch.testing.assert_close(y, y_p, rtol=0.0,
                               atol=5e-6 * float(y_p.abs().max()))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", K2_NS)
def test_k2_cuda_error_vs_complex128(n, inverse):
    """The kernel's and the einsum's errors against complex128, side by
    side: both within 5e-6 of the output scale."""
    x = _k2_input(n, 3)
    w = dft_matrix(n, inverse, x.device)
    want = axis_dft_plain(x.to(torch.complex128), w.to(torch.complex128))
    scale = float(want.abs().max())
    err_k = float((axis_dft(x, inverse).to(torch.complex128)
                   - want).abs().max())
    err_p = float((axis_dft_plain(x, w).to(torch.complex128)
                   - want).abs().max())
    assert err_p <= 5e-6 * scale
    assert err_k <= 5e-6 * scale


@pytest.mark.parametrize("shape", [(2, 16, 5, 16),    # tiles of 2 j rows
                                   (3, 60, 9, 40),    # k tiles 32 + 8
                                   (2, 34, 4, 10),    # the dense stage
                                   (1, 7, 3, 3),      # odd K: cp.async
                                   (2, 50, 6, 25),    # odd K: cp.async
                                   (4, 120, 3, 50)])  # J, K != A
def test_k2_cuda_tiles_and_load_paths(shape):
    """Ragged tiles and both load paths (TMA, and cp.async where K * 8
    bytes is no multiple of 16) against the plain version, both
    directions."""
    x = _k2_input(0, 5, shape=shape)
    for inverse in (False, True):
        y = axis_dft(x, inverse)
        y_p = axis_dft_plain(x, dft_matrix(shape[1], inverse, x.device))
        torch.testing.assert_close(y, y_p, rtol=0.0,
                                   atol=5e-6 * float(y_p.abs().max()))


@pytest.mark.parametrize("n", [75, 120])
def test_k2_cuda_dft3_matches_fftn_and_returns_x(n):
    x = _k2_input(n, 7, b=3)
    mats = dft_mats(n, torch.complex64, x.device)
    f = dft3(x, mats)
    ref = torch.fft.fftn(x, dim=(-3, -2, -1))
    torch.testing.assert_close(f, ref, rtol=0.0,
                               atol=5e-6 * float(ref.abs().max()))
    torch.testing.assert_close(dft3(f, mats, inverse=True), x, rtol=0.0,
                               atol=5e-6 * float(x.abs().max()))


def test_kernels_reject_non_contiguous_cuda_input():
    dev = _cuda()
    x = torch.zeros((2, 8, 8, 8), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        axis_dft(x.transpose(1, 2))


def test_complex64_solve_on_cuda_matches_cpu():
    """sc_curv N=16: the solve through K1/K2 on the card reaches the same
    frequencies as the plain versions on the CPU (complex64 iterates:
    5e-5, tests/test_pallas.py:160), and launches both kernels."""
    dev = _cuda()
    cfg = ProblemConfig(n=16, lattice="sc_curv", nev=6)
    alpha = np.array([np.pi, 0.0, 0.0])
    n1, n2 = resid_precond.launches, axis_dft.launches
    r_gpu = KPointSolver(cfg, device=dev, dtype=torch.complex64).solve(alpha)
    assert resid_precond.launches > n1 and axis_dft.launches > n2
    r_cpu = KPointSolver(cfg, device="cpu", dtype=torch.complex64).solve(alpha)
    assert r_gpu.status in (1, 5) and r_cpu.status in (1, 5)
    assert not r_gpu.report.spurious
    np.testing.assert_allclose(r_gpu.omega_re, r_cpu.omega_re, atol=5e-5)


@pytest.mark.parametrize("w_cap", [4, "auto"])
def test_complex64_w_cap_solve_on_cuda_matches_cpu(w_cap):
    """sc_curv N=16 with ``col_patience=3`` and a W/P width cap: on the card
    K1 runs at the block width and K2's W applies at batch 3 wc (at 3 x 4
    for the int cap), and the frequencies are the CPU solve's to 5e-5."""
    dev = _cuda()
    cfg = ProblemConfig(n=16, lattice="sc_curv", nev=6)
    alpha = np.array([np.pi, 0.0, 0.0])
    opts = {"col_patience": 3, "w_cap": w_cap}
    n1, by_b = resid_precond.launches, dict(axis_dft.launches_by_batch)
    r_gpu = KPointSolver(cfg, device=dev, dtype=torch.complex64,
                         solver_opts=dict(opts)).solve(alpha)
    assert resid_precond.launches > n1
    launched = {b for b, c in axis_dft.launches_by_batch.items()
                if c > by_b.get(b, 0)}
    assert {3 * w for w in r_gpu.widths} <= launched
    if w_cap == 4:
        assert set(r_gpu.widths) == {4}
    r_cpu = KPointSolver(cfg, device="cpu", dtype=torch.complex64,
                         solver_opts=dict(opts)).solve(alpha)
    assert r_gpu.status in (1, 5) and r_cpu.status in (1, 5)
    assert not r_gpu.report.spurious
    np.testing.assert_allclose(r_gpu.omega_re, r_cpu.omega_re, atol=5e-5)


@pytest.mark.parametrize("solver", ["davidson", "mixed"])
def test_complex64_solver_variant_on_cuda_matches_cpu(solver):
    """sc_curv N=16: Davidson (K2 in the operator, capped at 200 iterations:
    it has no FLOOR rule) and ``"mixed"`` (K2 and, with rr_gram="pallas",
    K3; never K1) on the card reach the CPU solve's frequencies to the
    complex64 golden scale, 3.5e-3."""
    dev = _cuda()
    cfg = ProblemConfig(n=16, lattice="sc_curv", nev=6)
    alpha = np.array([np.pi, 0.0, 0.0])
    kw = dict(dtype=torch.complex64, solver=solver, maxiter=200,
              solver_opts={"rr_gram": "pallas"} if solver == "mixed" else {})
    n1, n2, n3 = resid_precond.launches, axis_dft.launches, gram9.launches
    r_gpu = KPointSolver(cfg, device=dev, **kw).solve(alpha)
    assert axis_dft.launches > n2
    assert resid_precond.launches == n1
    assert (gram9.launches > n3) is (solver == "mixed")
    r_cpu = KPointSolver(cfg, device="cpu", **kw).solve(alpha)
    assert r_gpu.status in (1, 2, 5) and r_cpu.status in (1, 2, 5)
    assert not r_gpu.report.spurious and not r_cpu.report.spurious
    np.testing.assert_allclose(r_gpu.omega_re, r_cpu.omega_re, atol=3.5e-3)


def test_k3_cuda_matches_plain():
    """K3 at the sweep's width with a ragged D tail (the last chunk holds
    37 + 2048 * k columns), against the plain version: f32 chunk partials
    on both sides, other summation order inside a chunk."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    m, d = 16, 3 * 120 ** 3 + 37
    blocks = [torch.randn((m, d), generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(6)]
    n0 = gram9.launches
    t = gram9(*blocks)
    t_p = gram9_plain(*blocks)
    torch.cuda.synchronize()
    assert gram9.launches == n0 + 1
    assert t.dtype == torch.complex128 and t.shape == (3 * m, 3 * m)
    torch.testing.assert_close(t, t_p, rtol=0.0,
                               atol=1e-5 * float(t_p.abs().max()))
    # a width that is not 16: rows and columns past 3m are masked
    small = [b[:5, :4099].contiguous() for b in blocks]
    t_p = gram9_plain(*small, chunk=512)
    torch.testing.assert_close(gram9(*small, chunk=512), t_p, rtol=0.0,
                               atol=1e-5 * float(t_p.abs().max()))


@pytest.mark.parametrize("m,d,chunk", [(16, 3 * 120 ** 3 + 37, 2048),
                                       (5, 4099, 512)])
def test_k3_cuda_error_vs_complex128(m, d, chunk):
    """The kernel's and the plain version's errors against complex128, side
    by side, with a ragged D tail: both within 1e-5 of max|T|."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    blocks = [torch.randn((m, d), generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(6)]
    s, hs = (torch.cat(b).to(torch.complex128)
             for b in (blocks[:3], blocks[3:]))
    want = s.conj() @ hs.T
    del s, hs
    scale = float(want.abs().max())
    err_k = float((gram9(*blocks, chunk=chunk) - want).abs().max())
    err_p = float((gram9_plain(*blocks, chunk=chunk) - want).abs().max())
    assert err_p <= 1e-5 * scale
    assert err_k <= 1e-5 * scale


@pytest.mark.parametrize("m", [16, 48])
def test_solver_grams_on_cuda_vs_complex128(m):
    """The dense algebra's complex64 Grams (``gram_f64`` and the projection
    ``gram``) at the main path's D against complex128: within 1e-6 of
    max|G|.  With 65536-column partials and ``gram`` as one GEMM they
    carried 3.6e-6 - 5.3e-6, which set the solvers' residual floor."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    d = 3 * 120 ** 3
    x, y = (torch.randn((m, d), generator=gen, device=dev,
                        dtype=torch.complex64) for _ in range(2))
    want = x.to(torch.complex128).conj() @ y.to(torch.complex128).T
    scale = float(want.abs().max())
    assert float((rr.gram_f64(x, y) - want).abs().max()) <= 1e-6 * scale
    assert float((rr.gram(x, y).to(torch.complex128) - want).abs().max()
                 ) <= 1e-6 * scale


def _sweep(tmp_path, name, device, **kw):
    out = str(tmp_path / name)
    err = bs.bandgap(output_dir=out, verbose=False, device=device, **kw)
    assert err == []
    with open(os.path.join(out, kw.get("diel_type", "chiral"),
                           f"bandgap_{kw['lattice']}.json")) as f:
        return json.load(f)


def test_complex64_sweep_on_cuda_matches_cpu(tmp_path):
    """bandgap of 3 points at N=16, complex64, rr_gram="pallas": through
    K1, K2 and K3 on the card, through their plain versions on the CPU;
    complex64 iterates: frequencies to 5e-5 (tests/test_pallas.py:160)."""
    dev = _cuda()
    kw = dict(n=16, lattice="sc_curv", nev=6, gap=5, indices=[0, 1, 2],
              dtype=torch.complex64, solver_opts={"rr_gram": "pallas"})
    n0 = (resid_precond.launches, axis_dft.launches, gram9.launches)
    lib_gpu = _sweep(tmp_path, "gpu", dev, **kw)
    n1 = (resid_precond.launches, axis_dft.launches, gram9.launches)
    assert all(b > a for a, b in zip(n0, n1))
    lib_cpu = _sweep(tmp_path, "cpu", "cpu", **kw)
    key = "sc_curv_16_frequencies"
    np.testing.assert_allclose(np.array(lib_gpu[key][:3]),
                               np.array(lib_cpu[key][:3]), rtol=0, atol=5e-5)


def test_complex128_sweep_reproduces_committed_library(tmp_path):
    """The port's complex128 sweep on the card reproduces the committed
    f64 library examples/bandgap_sc_flat1_n32.json (20 points, gap 5 from
    its row count) to 1e-8."""
    dev = _cuda()
    src = os.path.join(ROOT, "examples", "bandgap_sc_flat1_n32.json")
    ref, alphas = bs._open_library(src, "sc_flat1", 32, None)
    lib = _sweep(tmp_path, "f64", dev, n=32, lattice="sc_flat1", nev=10,
                 gap=alphas.shape[0] // 4, dtype=torch.complex128)
    got = np.array(lib["sc_flat1_32_frequencies"])
    np.testing.assert_allclose(got, np.array(ref.frequencies), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("diel_type,eps_opt,k", [
    ("pseudochiral_trivial", 0, 1), ("pseudochiral_trivial", 3, 1),
    ("pseudochiral_crossdof", 0, 1), ("pseudochiral_crossdof", 3, 1),
    ("pseudochiral_crossdof", 2, 2)])
def test_pseudochiral_apply_complex64_matches_complex128_on_cuda(
        diel_type, eps_opt, k):
    """The Hermitian-tensor eps^{-1} applies at N=32 on the card: the
    complex64 form (float32 masks and diagonals, Python-scalar eps entries)
    stays complex64 and agrees with the complex128 form to float32
    rounding, and the complex128 form agrees with the CPU's."""
    dev = _cuda()
    n = 32
    op = dielectric.build(diel_type, n, "sc_curv", dev, eps_opt=eps_opt, k=k)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randn((4, 3, n, n, n), generator=gen, device=dev,
                    dtype=torch.complex128)
    y64 = op(x)
    y32 = op(x.to(torch.complex64))
    assert y32.dtype == torch.complex64 and y64.dtype == torch.complex128
    scale = float(y64.abs().max())
    assert float((y32.to(torch.complex128) - y64).abs().max()) <= 2e-6 * scale
    cpu = dielectric.build(diel_type, n, "sc_curv", "cpu", eps_opt=eps_opt,
                           k=k)
    torch.testing.assert_close(y64.cpu(), cpu(x.cpu()), rtol=0.0,
                               atol=1e-13 * scale)
    # <x, M y> = conj <y, M x>
    y = torch.randn_like(x)
    a, b = torch.vdot(x.flatten(), op(y).flatten()), torch.vdot(
        y.flatten(), y64.flatten())
    assert abs(a - b.conj()) <= 1e-12 * abs(a)


def test_complex128_crossdof_sweep_on_cuda_matches_cpu(tmp_path):
    """bandgap of the cross-DoF dielectric at N=32, complex128, rows 1-2
    (one cold point, one warm): CONVERGED complex128 solves on the card and
    on the CPU agree to 1e-9."""
    dev = _cuda()
    kw = dict(n=32, lattice="sc_curv", diel_type="pseudochiral_crossdof",
              nev=6, gap=5, indices=[1, 2], dtype=torch.complex128)
    lib_gpu = _sweep(tmp_path, "gpu", dev, **kw)
    lib_cpu = _sweep(tmp_path, "cpu", "cpu", **kw)
    key = "sc_curv_32_frequencies"
    np.testing.assert_allclose(np.array(lib_gpu[key][1:3]),
                               np.array(lib_cpu[key][1:3]), rtol=0,
                               atol=1e-9)


def test_light_refine_on_cuda_matches_complex128_refine():
    """sc_curv N=64, a complex64 solve on the card: the light refine (K2 in
    its applies) and the complex128 refine of the same block agree on the
    leading Ritz values to 1e-5 relative and on the frequencies to 1e-4,
    a tenth of the spurious gate, with the same verdict."""
    dev = _cuda()
    kps = KPointSolver(ProblemConfig(n=64, lattice="sc_curv", nev=10),
                       device=dev, dtype=torch.complex64, refine="light")
    alpha = np.array([np.pi, 0.0, 0.0])
    r = kps.solve(alpha, validate_result=False)
    assert r.status in (1, 5)
    n2 = axis_dft.launches
    rep_l, theta_l = kps._refine_report(alpha, r.x, raise_on_spurious=False)
    assert axis_dft.launches > n2
    rep_h, theta_h = kps._refine_report(alpha, r.x, raise_on_spurious=False,
                                        mode="f64")
    np.testing.assert_allclose(theta_l[:10], theta_h[:10], rtol=1e-5)
    np.testing.assert_allclose(rep_l.omega_re, rep_h.omega_re, atol=1e-4)
    np.testing.assert_allclose(rep_l.omega_pnt, rep_h.omega_pnt, atol=1e-4)
    assert rep_l.spurious == rep_h.spurious is False


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)])
def test_resample3_on_cuda_matches_cpu(dtype, tol):
    """The two-grid lift (30 -> 60) of a 16-column block on the card against
    the same on the CPU, relative to the block's largest entry."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((16, 3, 30, 30, 30), generator=gen, dtype=dtype)
    u = torch.as_tensor(upsample_mat(30, 60)).to(dtype)
    cpu = resample3(x, u)
    got = resample3(x.to(dev), u.to(dev)).cpu()
    assert got.shape == (16, 3, 60, 60, 60)
    assert float((got - cpu).abs().max()) <= tol * float(cpu.abs().max())


def test_complex_route_dfts_on_cuda_agree():
    """``solver_impl="complex"`` at sc_curv N=16 in complex64 on the card:
    with ``fft_mode="matmul"`` the operator runs K2, with ``"fft"`` cuFFT
    and no K2; both reach the CPU's complex128 frequencies to 5e-5."""
    dev = _cuda()
    cfg = ProblemConfig(n=16, lattice="sc_curv", nev=6)
    alpha = np.array([np.pi, 0.0, 0.0])
    ref = KPointSolver(cfg, device="cpu").solve(alpha).omega_re
    for mode in ("matmul", "fft"):
        n2 = axis_dft.launches
        r = KPointSolver(cfg, device=dev, dtype=torch.complex64,
                         solver_impl="complex", fft_mode=mode).solve(alpha)
        assert (axis_dft.launches > n2) is (mode == "matmul")
        assert r.status in (1, 5) and not r.report.spurious
        np.testing.assert_allclose(r.omega_re, ref, atol=5e-5)


def test_pack_cmp_on_cuda_launches_k1_and_k2(tmp_path):
    """``pack_cmp`` on the card runs the production complex64 solve: K1 and
    K2 launch, and the table has the committed schema with positive
    synchronized seconds."""
    from pcx_torch.experiments import runtime
    _cuda()
    k1, k2 = resid_precond.launches, axis_dft.launches
    seen = []
    out = runtime.pack_cmp([32], "sc_curv", nev=6, run_cpu=False,
                           verbose=False, output_path=str(tmp_path / "r.json"),
                           on_point=lambda n, s, r: seen.append((n, r.status)))
    assert resid_precond.launches > k1 and axis_dft.launches > k2
    rec = out["sc_curv_32"]
    assert rec[0] > 0 and rec[2] > 0 and np.isnan(rec[1])
    assert seen and seen[0][0] == 32 and seen[0][1] in (1, 5)
    with open(tmp_path / "r.json") as f:
        assert list(json.load(f)) == ["sc_curv_32"]


def test_phase_breakdown_on_cuda():
    """``phase_breakdown`` on the card: the spans' CUDA-event times, all
    positive and within the measured iteration, the operator through K2
    (complex64), and the card's peak memory."""
    from pcx_torch.lattices import k_path
    from pcx_torch.profiling import phase_breakdown
    dev = _cuda()
    solver = KPointSolver(ProblemConfig(n=32, lattice="fcc", nev=10),
                          device=dev, dtype=torch.complex64)
    k2 = axis_dft.launches
    out = phase_breakdown(solver, k_path("fcc")[9], m=16, repeats=3,
                          verbose=False)
    assert axis_dft.launches > k2
    phases = ("operator_s", "precond_s", "gram_rr_s", "ortho_s")
    for k in phases + ("iteration_s", "memory_mib"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert sum(out[k] for k in phases) < out["iteration_s"]


def _n24_pin() -> dict:
    with open(os.path.join(ROOT, "data", "bcc_sg_n24_k37_f64.json")) as f:
        return json.load(f)


def test_complex64_gyroid_solve_on_cuda_matches_the_f64_pin():
    """A complex64 solve on the card at bcc_sg N=24, k_path index 37, with
    record_vs_truth's termination levers, lies within 5e-5 of the committed
    complex128 pin data/bcc_sg_n24_k37_f64.json: the gate of the JAX
    package's live test (tests/test_bandstructure.py,
    test_live_c64_solve_matches_f64_ground_truth)."""
    from pcx_torch.lattices import k_path
    from pcx_torch.record_vs_truth import LEVERS
    dev = _cuda()
    truth = _n24_pin()
    alpha = k_path("bcc_sg")[truth["k"]]
    np.testing.assert_allclose(alpha / np.pi, truth["alpha_over_pi"],
                               atol=1e-9)
    kps = KPointSolver(ProblemConfig(n=24, lattice="bcc_sg", nev=10),
                       device=dev, dtype=torch.complex64, refine=False,
                       solver_opts=dict(LEVERS))
    k1, k2 = resid_precond.launches, axis_dft.launches
    res = kps.solve(alpha, seed=0)
    assert resid_precond.launches > k1 and axis_dft.launches > k2
    np.testing.assert_allclose(res.omega_re[:10], truth["omega_f64"],
                               rtol=0, atol=5e-5)


def test_f64_truth_on_cuda_reproduces_the_f64_pin():
    """``f64_truth`` on the card (complex128) reproduces the committed pin
    data/bcc_sg_n24_k37_f64.json, a CPU solve of the JAX package, to 1e-6,
    in the committed record's keys."""
    from pcx_torch import f64_truth as ft
    dev = _cuda()
    truth = _n24_pin()
    out = ft.f64_truth("bcc_sg", 24, truth["k"], device=dev)
    assert out.record["status"] in (1, 5)
    assert list(out.record) == list(truth)
    assert out.peak_gib > 0
    np.testing.assert_allclose(out.record["omega_f64"], truth["omega_f64"],
                               rtol=0, atol=1e-6)


def test_bench_single_point_on_cuda():
    """``python -m pcx_torch.bench --sweep 0 --n 32`` in-process on the
    card: complex64 solves through K1 and K2, each CONVERGED or FLOOR, and
    the JSON record with the card's name in ``device``."""
    from pcx_torch import bench
    _cuda()
    k1, k2 = resid_precond.launches, axis_dft.launches
    code, rec, points = bench.run(["--sweep", "0", "--n", "32"])
    assert code == 0 and len(points) == 2
    assert resid_precond.launches > k1 and axis_dft.launches > k2
    assert rec["metric"] == "sc_curv_n32_kpoint_solve_seconds"
    assert rec["value"] > 0 and rec["device"] != "cpu"
    assert all(p["status"] in ("CONVERGED", "FLOOR") for p in points)


@pytest.mark.parametrize("lanes", [3, 1])
def test_k1_lanes_cuda_matches_plain(lanes):
    """K1 on a lane axis: one launch for all lanes, counted once per lane,
    each lane with its own symbol, against the plain version (the one-lane
    tolerances), and lane i against the kernel without a lane axis on lane
    i."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    m, d = 16, 32 ** 3 + 37
    c = lambda *s: torch.randn(s, generator=gen, device=dev,
                               dtype=torch.complex64)
    args = (c(lanes, m, 3, d), c(lanes, m, 3, d),
            torch.rand((lanes, m), generator=gen, device=dev) * 100,
            torch.rand((lanes, 3, d), generator=gen, device=dev),
            0.1 * c(lanes, 3, d))
    n0 = resid_precond.launches
    w, ss = resid_precond(*args)
    w_p, ss_p = resid_precond_plain(*args)
    torch.cuda.synchronize()
    assert resid_precond.launches == n0 + lanes
    assert w.shape == (lanes, m, 3, d) and ss.shape == (lanes, m)
    torch.testing.assert_close(w, w_p, rtol=1e-5,
                               atol=1e-6 * float(w_p.abs().max()))
    torch.testing.assert_close(ss, ss_p, rtol=1e-5, atol=0.0)
    for i in range(lanes):
        w1, ss1 = resid_precond(*(a[i] for a in args))
        torch.testing.assert_close(w[i], w1, rtol=0.0, atol=0.0)
        torch.testing.assert_close(ss[i], ss1, rtol=0.0, atol=0.0)
    assert resid_precond.launches == n0 + 2 * lanes


@pytest.mark.parametrize("lanes", [3, 1])
def test_k3_lanes_cuda_matches_plain(lanes):
    """K3 on a lane axis: one launch of each kernel for all lanes, counted
    once per lane, against the plain version (1e-5 of max|T|, the one-lane
    tolerance), and lane i against the kernel without a lane axis on lane
    i (a partial depends only on its lane and chunk)."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    m, d = 16, 3 * 32 ** 3 + 37
    blocks = [torch.randn((lanes, m, d), generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(6)]
    n0 = gram9.launches
    t = gram9(*blocks)
    t_p = gram9_plain(*blocks)
    torch.cuda.synchronize()
    assert gram9.launches == n0 + lanes
    assert t.shape == (lanes, 3 * m, 3 * m) and t.dtype == torch.complex128
    torch.testing.assert_close(t, t_p, rtol=0.0,
                               atol=1e-5 * float(t_p.abs().max()))
    for i in range(lanes):
        torch.testing.assert_close(t[i], gram9(*(b[i] for b in blocks)),
                                   rtol=0.0, atol=0.0)
    assert gram9.launches == n0 + 2 * lanes
    # a width that is not 16 and an odd D: the unvectorized loads
    small = [b[:, :5, :4099].contiguous() for b in blocks]
    t_p = gram9_plain(*small, chunk=512)
    torch.testing.assert_close(gram9(*small, chunk=512), t_p,
                               rtol=0.0, atol=1e-5 * float(t_p.abs().max()))


def test_solve_batch_lanes_on_cuda_match_serial():
    """A lane-batched complex64 solve of three fcc points at N=32 on the
    card (K1 and K3 on the lane axis, rr_gram="pallas") against the same
    points solved one by one on the card from the same starts: each member
    CONVERGED or FLOOR, not spurious, omega_re within 1e-4 of the serial
    solve (complex64 solves, another order of rounding).  K1 counts each
    lane once in each of its iterations and at its stop, K3 in each of its
    iterations, in the group as in a solve."""
    from pcx_torch.lattices import k_path
    dev = _cuda()
    alphas = [k_path("fcc")[i] for i in (9, 10, 11)]
    kps = KPointSolver(ProblemConfig(n=32, lattice="fcc", nev=6),
                       device=dev, dtype=torch.complex64,
                       solver_opts={"rr_gram": "pallas"})

    def count():
        return resid_precond.launches, gram9.launches

    n0 = count()
    res = kps.solve_batch(alphas, seed=4)
    its = sum(r.iterations for r in res)
    assert count() == (n0[0] + its + len(res), n0[1] + its)
    for i, (a, r) in enumerate(zip(alphas, res)):
        n0 = count()
        s = kps.solve(a, seed=4 + i)
        assert count() == (n0[0] + s.iterations + 1, n0[1] + s.iterations)
        assert r.status in (1, 5) and s.status in (1, 5)
        assert not r.report.spurious
        np.testing.assert_allclose(r.omega_re, s.omega_re, atol=1e-4)


def test_complex_impl_solve_batch_lanes_on_cuda_match_serial():
    """``solver_impl="complex"``: a lane-batched complex64 solve of three
    fcc points at N=32 on the card (``lobpcg_sep_lanes``, K2 over all
    lanes' columns, no K1 or K3) against the same points solved one by
    one on the card from the same starts: each member CONVERGED or FLOOR,
    not spurious, omega_re within 1e-4 of the serial solve."""
    from pcx_torch import kernels as kmod
    from pcx_torch.lattices import k_path
    dev = _cuda()
    alphas = [k_path("fcc")[i] for i in (9, 10, 11)]
    kps = KPointSolver(ProblemConfig(n=32, lattice="fcc", nev=6),
                       device=dev, dtype=torch.complex64,
                       solver_impl="complex")
    m = kps.block_width(alphas[0])
    n0 = kmod.launches()
    b0 = dict(axis_dft.launches_by_batch)
    res = kps.solve_batch(alphas, seed=4)
    n1 = kmod.launches()
    assert axis_dft.launches_by_batch.get(9 * m, 0) > b0.get(9 * m, 0)
    # K2, K4 and K6 (the dense algebra) and K5 (the operator's block
    # multiplies) serve the complex path; K1, K3 not
    serve = ("axis_dft", "block_combine", "op_pre", "op_post", "gram_chunks")
    assert all(n1[k] == n0[k] for k in n0 if k not in serve)
    assert all(n1[k] > n0[k] for k in serve[1:])
    for i, (a, r) in enumerate(zip(alphas, res)):
        s = kps.solve(a, seed=4 + i)
        assert r.status in (1, 5) and s.status in (1, 5)
        assert not r.report.spurious
        np.testing.assert_allclose(r.omega_re, s.omega_re, atol=1e-4)


# K4 at the main path's shapes: slices of a stacked (L, 48, D) block as
# inputs, N=120; the rows of each input block, and the output rows q
K4_SPLITS = [(16,), (32,), (16, 16, 16)]


def _k4_operands(dev, seed, lanes, rows, q, d, addend=False):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = lambda *s: torch.randn(s, generator=gen, device=dev,
                               dtype=torch.complex64)
    lead = (lanes,) if lanes > 1 else ()
    stack = c(*lead, 48, d)
    offs = np.cumsum((0,) + rows)
    blocks = tuple(stack[..., o:o + r, :] for o, r in zip(offs, rows))
    coeffs = tuple(c(*lead, r, q) for r in rows)
    return blocks, coeffs, (c(*lead, q, d) if addend else None)


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("q", [4, 8, 10, 16])
@pytest.mark.parametrize("rows", K4_SPLITS, ids=lambda r: "+".join(map(str, r)))
def test_k4_cuda_matches_plain(rows, q, lanes):
    """K4 against its plain version (cuBLAS cgemm, f32) at the main path's
    shapes: alone and with an addend subtracted."""
    dev = _cuda()
    d = 3 * 120 ** 3
    blocks, coeffs, add = _k4_operands(dev, q + lanes, lanes, rows, q, d,
                                       addend=True)
    for kw in ({}, {"addend": add, "subtract": True}):
        n0 = block_combine.launches
        got = block_combine(blocks, coeffs, **kw)
        want = block_combine_plain(blocks, coeffs, **kw)
        torch.cuda.synchronize()
        assert block_combine.launches == n0 + 1
        assert got.shape == want.shape and got.is_contiguous()
        # f32 on both sides, another order of the sum over the rows
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("d,rows,q", [
    (3 * 75 ** 3, (16, 16), 16),          # odd D: the 8-byte load path
    (3 * 120 ** 3 + 2, (16,), 20),        # a ragged last tile; q in chunks
    (1000, (100, 60, 32), 64),            # 192 rows: the most shared
    (6, (3,), 1)])                        # less than one tile
def test_k4_cuda_tails_and_load_paths(d, rows, q):
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    c = lambda *s: torch.randn(s, generator=gen, device=dev,
                               dtype=torch.complex64)
    stack = c(sum(rows) + 1, d)[1:]     # odd row offset: 8-byte aligned
    offs = np.cumsum((0,) + rows)
    blocks = tuple(stack[o:o + r] for o, r in zip(offs, rows))
    coeffs = tuple(c(r, q) for r in rows)
    add = c(q, d)
    for kw in ({}, {"addend": add, "subtract": True}):
        got = block_combine(blocks, coeffs, **kw)
        want = block_combine_plain(blocks, coeffs, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("rows,addend", [((16, 16, 16), False),
                                         ((16, 16), True), ((16,), False)])
def test_k4_cuda_error_vs_complex128(rows, addend):
    """K4's error against complex128 is no worse than 1.5x that of one
    torch.matmul cgemm over the stacked complex64 inputs, the addend
    subtracted after it (relative Frobenius norm of the difference)."""
    dev = _cuda()
    d = 3 * 120 ** 3
    blocks, coeffs, add = _k4_operands(dev, 7, 1, rows, 16, d, addend)
    kw = {"addend": add, "subtract": True} if addend else {}
    exact = block_combine_plain(
        [b.to(torch.complex128) for b in blocks],
        [c.to(torch.complex128) for c in coeffs],
        None if add is None else add.to(torch.complex128), addend)
    norm = float(torch.linalg.vector_norm(exact))

    def err(out):
        return float(torch.linalg.vector_norm(out.to(torch.complex128)
                                              - exact)) / norm

    lib = torch.matmul(torch.cat(coeffs, -2).mT, torch.cat(blocks, -2))
    err_k = err(block_combine(blocks, coeffs, **kw))
    err_lib = err(lib if add is None else add - lib)
    assert err_k <= 1.5 * err_lib, (err_k, err_lib)


@pytest.mark.parametrize("opts", [{}, {"rr_gram": "pallas"},
                                  {"solver_impl": "complex"}],
                         ids=["xla", "pallas", "complex"])
def test_k4_takes_every_combination_of_a_complex64_solve(opts):
    """A complex64 solve with the light refine on the card: every block
    combination launches K4 (``dense.matmul`` stays 0) and ``k4.bytes``
    counts its launches."""
    from pcx_torch import kernels as kmod
    from pcx_torch import tracing
    dev = _cuda()
    opts = dict(opts)
    impl = opts.pop("solver_impl", "rs")
    kps = KPointSolver(ProblemConfig(n=24, lattice="fcc", nev=6),
                       device=dev, dtype=torch.complex64, refine="light",
                       solver_impl=impl, solver_opts=opts)
    kmod.reset_launches()
    res = kps.solve(np.array([np.pi, 0.0, 0.0]))
    counts = tracing.counts()
    assert res.status in (1, 5)
    assert counts.get("dense.matmul", 0) == 0
    assert counts["dense.k4"] == block_combine.launches > 0
    assert counts["k4.bytes"] > 0


def test_k4_route_raises_where_k4_cannot_read_and_counts_past_its_limits():
    """``rr.combine`` on the card routes by dtype and size alone: a
    complex64 call within K4's limits whose operand K4 cannot read (a
    non-unit stride along D, a lazily conjugated coefficient) raises
    rather than taking ``torch.matmul``; a complex64 call past the row
    limit takes it and counts ``dense.matmul``; complex128 takes it
    uncounted."""
    from pcx_torch import kernels as kmod
    from pcx_torch import tracing
    from pcx_torch.kernels.block_combine import MAX_ROWS
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    c = lambda *s: torch.randn(s, generator=gen, device=dev,
                               dtype=torch.complex64)
    with pytest.raises(ValueError, match="stride"):
        rr.combine((c(8, 2 * 640)[:, ::2],), (c(8, 4),))
    with pytest.raises(ValueError, match="conjugated"):
        rr.combine((c(8, 640),), (c(8, 4).conj(),))
    kmod.reset_launches()
    big, coef = c(MAX_ROWS + 1, 640), c(MAX_ROWS + 1, 4)
    got = rr.combine((big,), (coef,))
    rr.combine((big.to(torch.complex128),), (coef.to(torch.complex128),))
    torch.testing.assert_close(got, coef.mT @ big)
    assert tracing.counts().get("dense.matmul") == 1
    assert tracing.counts().get("dense.k4", 0) == 0
    assert block_combine.launches == 0


def _k5_operands(dev, seed, n, c, lanes=None, offset=False):
    """x, z, d_a, b and a shift (a number, or the lanes' real tensor) in
    the operator's layouts at grid n; ``offset`` puts every block and
    symbol one complex element past an aligned start (8-byte loads)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lead = (c,) if lanes is None else (lanes, c)
    slead = () if lanes is None else (lanes, 1)
    comp = (3, n, n, n)

    def make(shape, dtype=torch.complex64):
        k = int(np.prod(shape)) + int(offset)
        full = (torch.randn if dtype.is_complex else torch.rand)(
            (k,), generator=gen, device=dev, dtype=dtype)
        return full[int(offset):].view(shape)

    b = sym.HermSymbol(make(slead + comp, torch.float32), make(slead + comp))
    shift = (3.17 if lanes is None else
             torch.rand((lanes,) + (1,) * 5, generator=gen, device=dev))
    return (make(lead + comp), make(lead + comp), make(slead + comp), b,
            shift)


def _k5_check(x, z, d_a, b, shift):
    """Each entry point against its plain version on the card, bit for
    bit: pre, post without the penalty, post with it."""
    from pcx_torch.kernels.op_blocks import (op_post, op_post_plain, op_pre,
                                             op_pre_plain)
    n0 = (op_pre.launches, op_post.launches)
    for got, want in ((op_pre(x, d_a), op_pre_plain(x, d_a)),
                      (op_post(z, d_a), op_post_plain(z, d_a)),
                      (op_post(z, d_a, x, b, shift),
                       op_post_plain(z, d_a, x, b, shift))):
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got, want), float((got - want).abs().max())
    assert (op_pre.launches, op_post.launches) == (n0[0] + 1, n0[1] + 2)


def test_k5_matches_the_eager_composition_bit_for_bit():
    """K5 at the main path's shapes, N=120 and m=16: each entry point
    equals the eager composition it replaces under ``torch.equal``, with
    the serial apply's number shift and with the shift 0 (left out)."""
    dev = _cuda()
    x, z, d_a, b, shift = _k5_operands(dev, 20, 120, 16)
    _k5_check(x, z, d_a, b, shift)
    _k5_check(x, z, d_a, b, 0.0)


@pytest.mark.parametrize("c", [1, 4, 5, 12])
@pytest.mark.parametrize("n", [100, 150])
def test_k5_tails_and_lanes(n, c):
    """Grids whose N^3 leaves a ragged last tile, any column count, one
    lane and four lanes with their own symbols and shifts (the lanes of a
    k-point batch): bit for bit against the plain version."""
    dev = _cuda()
    _k5_check(*_k5_operands(dev, n + c, n, c))
    _k5_check(*_k5_operands(dev, n - c, n, c, lanes=4))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("n,offset", [(75, False), (16, True)],
                         ids=["odd-N", "unaligned"])
def test_k5_eight_byte_path(n, offset):
    """An odd N^3, and operands one element past an aligned start, take
    the 8-byte loads: the same bits."""
    dev = _cuda()
    _k5_check(*_k5_operands(dev, n, n, 5, offset=offset))
    _k5_check(*_k5_operands(dev, n, n, 3, lanes=2, offset=offset))


def test_k5_error_vs_complex128():
    """K5's error against the same block multiplies in complex128 at N=120,
    m=16 (relative Frobenius norm) is the eager composition's: the same
    bits, below 1e-6."""
    from pcx_torch.kernels.op_blocks import (op_post, op_post_plain, op_pre,
                                             op_pre_plain)
    dev = _cuda()
    x, z, d_a, b, shift = _k5_operands(dev, 21, 120, 16)
    w = torch.complex128
    b128 = sym.HermSymbol(b.diag.double(), b.sdiag.to(w))
    for k5, eager, exact in (
            (lambda: op_pre(x, d_a), lambda: op_pre_plain(x, d_a),
             lambda: op_pre_plain(x.to(w), d_a.to(w))),
            (lambda: op_post(z, d_a, x, b, shift),
             lambda: op_post_plain(z, d_a, x, b, shift),
             lambda: op_post_plain(z.to(w), d_a.to(w), x.to(w), b128,
                                   shift))):
        ref = exact()
        norm = float(torch.linalg.vector_norm(ref))
        err_k = float(torch.linalg.vector_norm(k5().to(w) - ref)) / norm
        err_e = float(torch.linalg.vector_norm(eager().to(w) - ref)) / norm
        del ref
        assert err_k == err_e and err_k < 1e-6, (err_k, err_e)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("how", ["rs", "complex", "lanes"])
def test_k5_takes_every_apply_of_a_complex64_solve(how):
    """A complex64 solve with the light refine on the card (the rs solver,
    the complex family, and three lanes of a k-point batch): every operator
    apply launches K5's two passes (each pass's launches equal
    ``op.applies``) and ``k5.bytes`` counts them."""
    from pcx_torch import kernels as kmod
    from pcx_torch import tracing
    from pcx_torch.kernels.op_blocks import op_post, op_pre
    from pcx_torch.lattices import k_path
    dev = _cuda()
    kps = KPointSolver(ProblemConfig(n=24, lattice="fcc", nev=6),
                       device=dev, dtype=torch.complex64, refine="light",
                       solver_impl="complex" if how == "complex" else "rs")
    kmod.reset_launches()
    if how == "lanes":
        res = kps.solve_batch([k_path("fcc")[i] for i in (9, 10, 11)])
    else:
        res = [kps.solve(np.array([np.pi, 0.0, 0.0]))]
    counts = tracing.counts()
    assert all(r.status in (1, 5) for r in res)
    assert op_pre.launches == op_post.launches == counts["op.applies"] > 0
    assert counts["k5.bytes"] > 0


def test_k5_route_raises_where_k5_cannot_read():
    """On the card a complex64 apply always goes to K5, which raises on a
    block it cannot read (not contiguous) or a lazily conjugated symbol; a
    complex128 apply takes the eager composition and launches nothing."""
    from pcx_torch import kernels as kmod
    from pcx_torch.kernels.op_blocks import op_post, op_pre, op_pre_plain
    from pcx_torch.operators import maxwell
    dev = _cuda()
    x, _, d_a, b, shift = _k5_operands(dev, 22, 16, 4)
    xt = x.transpose(-1, -2)

    def diel(v):
        return 0.5 * v

    kmod.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        maxwell.ama_bb(xt, d_a, b, diel, shift)
    with pytest.raises(ValueError, match="conjugated"):
        maxwell.ama(x, d_a.conj(), diel)
    w = torch.complex128
    b128 = sym.HermSymbol(b.diag.double(), b.sdiag.to(w))
    got = maxwell.ama_bb(x.to(w), d_a.to(w), b128, diel, shift)
    want = maxwell.ama_bb(x, d_a, b, diel, shift)
    assert op_pre.launches == op_post.launches == 1
    torch.testing.assert_close(want.to(w), got, rtol=1e-5,
                               atol=1e-5 * float(got.abs().max()))
    with pytest.raises(ValueError, match="contiguous"):
        op_pre(xt, d_a)
    torch.testing.assert_close(op_pre(x, d_a), op_pre_plain(x, d_a),
                               rtol=0.0, atol=0.0)


# K6 at the main path's shapes, N=120 and m=16: left and right blocks of
# the (48, D) stacks X|W|P and HX|HW|HP (the six-block Rayleigh-Ritz Gram,
# the second SVQB's projection, a 16-row Gram)
K6_CASES = {"16x16": ((0,), (3,)), "32x16": ((0, 1), (2,)),
            "48x48": ((0, 1, 2), (3, 4, 5))}


def _k6_blocks(dev, seed, lanes=None, d=3 * 120 ** 3, m=16):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lead = () if lanes is None else (lanes,)
    stacks = [torch.randn(lead + (3 * m, d), generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(2)]
    return [s[..., i * m:(i + 1) * m, :] for s in stacks for i in range(3)]


def _rel(a, exact):
    return float(torch.linalg.vector_norm(a.to(torch.complex128) - exact)
                 / torch.linalg.vector_norm(exact))


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_error_vs_complex128(case):
    """K6 against the complex128 Gram of the same blocks: relative error
    no larger than 1.25 times the cuBLAS route's (its plain version: the
    chunked ``torch.matmul`` partials summed in complex128) and at most
    5e-7 (F3); two launches give the same bits."""
    from pcx_torch.kernels.gram_chunks import gram_chunks_plain
    from pcx_torch.kernels import gram_chunks
    dev = _cuda()
    blocks = _k6_blocks(dev, 30)
    left, right = ([blocks[i] for i in idx] for idx in K6_CASES[case])
    exact = gram_chunks_plain([b.to(torch.complex128) for b in left],
                              [b.to(torch.complex128) for b in right])
    n0 = gram_chunks.launches
    got = gram_chunks(left, right)
    again = gram_chunks(left, right)
    err_k, err_lib = _rel(got, exact), _rel(gram_chunks_plain(left, right),
                                            exact)
    assert gram_chunks.launches == n0 + 2
    assert torch.equal(got, again)
    assert err_k <= 1.25 * err_lib and err_k <= 5e-7, (err_k, err_lib)
    del blocks, exact
    torch.cuda.empty_cache()


@pytest.mark.parametrize("d,off,chunk", [
    (3 * 75 ** 3, 0, 0),         # odd D: 8-byte copies, odd chunk
    (3 * 120 ** 3 + 2, 0, 0),    # no divisor near 256: a ragged last chunk
    (3 * 16 ** 3, 1, 0),         # blocks one element off 16-byte alignment
    (5000, 0, 2048),             # K3's chunk: 64 stages a chunk
    (6, 0, 0)])                  # less than one stage
def test_k6_tails_and_load_paths(d, off, chunk):
    """Shapes off the main path: each against complex128 within 2x the
    cuBLAS route's error (and 1e-6), a self-Gram and its c64 rounding."""
    from pcx_torch.kernels.gram_chunks import gram_chunks_plain
    from pcx_torch.kernels import gram_chunks
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    stack = torch.randn((34, d + off), generator=gen, device=dev,
                        dtype=torch.complex64)[:, off:]
    a, b = stack[:16], stack[16:30]
    for left, right in (((a,), (b,)), ((a,), (a,)), ((a[:5], b[:9]), (a,))):
        exact = gram_chunks_plain([t.to(torch.complex128) for t in left],
                                  [t.to(torch.complex128) for t in right],
                                  chunk)
        got = gram_chunks(left, right, chunk)
        err_lib = _rel(gram_chunks_plain(left, right, chunk), exact)
        assert _rel(got, exact) <= max(2.0 * err_lib, 1e-6)
        assert torch.equal(gram_chunks(left, right, chunk, c64=True),
                           got.to(torch.complex64))


def test_k6_lanes_equal_the_one_lane_launches():
    """Four lanes in one launch: each lane's Gram equals that lane's own
    launch bit for bit, and the launch counts one per lane served."""
    from pcx_torch.kernels import gram_chunks
    dev = _cuda()
    blocks = _k6_blocks(dev, 31, lanes=4, d=3 * 64 ** 3)
    left, right = blocks[:3], blocks[3:]
    n0 = gram_chunks.launches
    got = gram_chunks(left, right)
    assert gram_chunks.launches == n0 + 4
    for i in range(4):
        assert torch.equal(got[i], gram_chunks([b[i] for b in left],
                                               [b[i] for b in right]))


def test_k6_xla_update_equals_the_stacked_mix():
    """The rs loop's ``"xla"`` update as three-block combinations over the
    separate X, W, P blocks (K4 sums the rows of all blocks in row order)
    equals ``rr.mix`` over the stacked [X|W|P] under ``torch.equal``, for
    X' and for P' (the W and P rows)."""
    dev = _cuda()
    x, w, pf = _k6_blocks(dev, 32)[:3]
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    c = torch.randn((48, 16), generator=gen, device=dev,
                    dtype=torch.complex64)
    sf = torch.cat((x, w, pf))
    cx, cw, cp = c[:16], c[16:32], c[32:]
    assert torch.equal(rr.combine((x, w, pf), (cx, cw, cp)), rr.mix(c, sf))
    assert torch.equal(rr.combine((w, pf), (cw, cp)),
                       rr.mix(c[16:], sf[16:]))


@pytest.mark.parametrize("how", ["rs", "complex", "lanes"])
def test_k6_takes_every_gram_of_a_complex64_solve(how, monkeypatch):
    """A warm complex64 fcc point with the light refine on the card (the
    rs solver, the complex family, three lanes of a k-point batch): every
    Gram the solver forms launches K6 (``dense.gram`` equals the Grams
    formed, ``dense.gram_plain`` 0) and ``gram.bytes`` counts them."""
    from pcx_torch import kernels as kmod
    from pcx_torch import tracing
    from pcx_torch.lattices import k_path
    dev = _cuda()
    kps = KPointSolver(ProblemConfig(n=24, lattice="fcc", nev=6),
                       device=dev, dtype=torch.complex64, refine="light",
                       solver_impl="complex" if how == "complex" else "rs")
    alphas = [k_path("fcc")[i] for i in (9, 10, 11)]
    start = kps.solve(alphas[0]).x
    formed = [0]
    gram = rr._gram

    def counted(*args):
        formed[0] += 1
        return gram(*args)

    monkeypatch.setattr(rr, "_gram", counted)
    kmod.reset_launches()
    if how == "lanes":
        res = kps.solve_batch(alphas, x0s=[start] * 3)
    else:
        res = [kps.solve(alphas[1], x0=start)]
    counts = tracing.counts()
    assert all(r.status in (1, 5) for r in res)
    assert counts.get("dense.gram_plain", 0) == 0
    assert counts["dense.gram"] == formed[0] > 0
    assert counts["gram.bytes"] > 0
