"""The port's CUDA kernels against their plain PyTorch versions, and a small
complex64 solve through the kernels against the same solve on the CPU.

Every test here needs a CUDA device and skips without one (the kernels have
no interpret mode).  The file imports torch and pcx_torch only, so it runs
where JAX is not installed; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig
from pcx_torch.kernels import axis_dft, resid_precond
from pcx_torch.kernels.axis_dft import axis_dft_plain
from pcx_torch.kernels.resid_precond import resid_precond_plain
from pcx_torch.operators.dft import dft_mats

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("n", [100, 120, 150])
def test_k2_cuda_matches_plain(n):
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((6, n, n, n), generator=gen, device=dev,
                    dtype=torch.complex64)
    w = dft_mats(n, torch.complex64, dev).fwd
    n0 = axis_dft.launches
    y = axis_dft(x, w)
    y_p = axis_dft_plain(x, w)
    torch.cuda.synchronize()
    assert axis_dft.launches == n0 + 1
    # IEEE f32 FMAs vs the einsum's f32 GEMM: 5e-6 of the output scale
    # (TF32 would show ~1e-3)
    torch.testing.assert_close(y, y_p, rtol=0.0,
                               atol=5e-6 * float(y_p.abs().max()))


def test_kernels_reject_non_contiguous_cuda_input():
    dev = _cuda()
    x = torch.zeros((2, 8, 8, 8), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        axis_dft(x.transpose(1, 2), torch.eye(8, dtype=torch.complex64,
                                             device=dev))


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
