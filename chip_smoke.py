"""Chip smoke test of the PyTorch / CUDA port (pcx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line with its numbers, and the first
failure ends the run with a non-zero exit:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the CUDA kernels (nvcc, sm_90a) from the sources.
3. k1      — K1 resid_precond vs its plain version at m=16, N=120.
4. k2      — K2 axis_dft vs the einsum at B=48, N=120, one pass and a full
             dft3 forward and back (against torch.fft.fftn).
5. operator — complex64 ama_bb through the kernels vs complex128 torch.fft
             on a 2-column block at N=120.
6. single  — cold sc_curv chiral N=120 nev=10 solve at alpha=(pi,0,0), the
             point of ``bench.py --sweep 0``, gated against the committed
             complex64 library row (output_c64/chiral/bandgap_sc_curv.json).
7. warm    — fcc chiral N=120: a cold solve at k_path("fcc")[9], then warm
             solves at 10 and 11 (the sweep protocol of bench.py), each
             gated like the single point against bandgap_fcc.json.

The kernel launch counts are reset just before phase 6 and read after
phases 6 and 7: both kernels must have launched in the solves.

The last line of standard output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
There is no CPU path: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 120
NEV = 10
SPURIOUS_TOL = 1e-3      # |omega - omega_re| gate (pcx validate.recompute)
GOLDEN_TOL = 3.5e-3      # complex64 golden scale (README, ROADMAP R3)

FAIL = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(FAIL)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke test needs a "
             "CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    print(f"phase device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__},"
          f" cuda {torch.version.cuda}", flush=True)
    return card


def phase_build() -> None:
    from pcx_torch.kernels import _build
    t0 = time.time()
    path = _build.build()
    _build.load()
    with open(path[:-3] + ".log") as f:
        report = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"phase build: {time.time() - t0:.2f} s -> {path}", flush=True)
    for ln in report:
        print(f"  ptxas: {ln}", flush=True)


def phase_k1(gen, dev) -> dict:
    from pcx_torch.kernels.resid_precond import (resid_precond,
                                                 resid_precond_plain)
    m, n = 16, 120
    d = n ** 3
    x = torch.randn((m, 3, d), generator=gen, device=dev,
                    dtype=torch.complex64)
    hx = torch.randn((m, 3, d), generator=gen, device=dev,
                     dtype=torch.complex64)
    lam = torch.rand((m,), generator=gen, device=dev) * 100.0
    inv_diag = torch.rand((3, d), generator=gen, device=dev)
    inv_sd = 0.1 * torch.randn((3, d), generator=gen, device=dev,
                               dtype=torch.complex64)
    args = (x, hx, lam, inv_diag, inv_sd)
    w_k, ss_k = resid_precond(*args)
    w_p, ss_p = resid_precond_plain(*args)
    torch.cuda.synchronize()
    err_w = max_err(w_k, w_p)
    w_scale = float(w_p.abs().max())
    ok_w = torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-6 * w_scale)
    ok_ss = torch.allclose(ss_k, ss_p, rtol=1e-5, atol=0.0)
    ms = cuda_ms(lambda: resid_precond(*args))
    plain_ms = cuda_ms(lambda: resid_precond_plain(*args))
    ss_rel = float(((ss_k - ss_p).abs() / ss_p.abs()).max())
    print(f"phase k1: m={m} N={n} max|dw|={err_w:.3e} (max|w| {w_scale:.3e})"
          f" max rel dsumsq={ss_rel:.3e} kernel {ms:.3f} ms plain "
          f"{plain_ms:.3f} ms", flush=True)
    if not (ok_w and ok_ss):
        fail("K1 disagrees with its plain version (w rtol 1e-5 atol "
             "1e-6*max|w|, sumsq rtol 1e-5)")
    return {"name": "resid_precond", "route": "cuda",
            "source": "pcx_torch/kernels/csrc/resid_precond.cu",
            "replaces": "pcx/operators/pallas_kernels.py:130",
            "max_abs_err": err_w, "ms": ms, "plain_ms": plain_ms}


def phase_k2(gen, dev) -> dict:
    from pcx_torch.kernels.axis_dft import axis_dft, axis_dft_plain
    from pcx_torch.operators.dft import dft3, dft_mats
    b, n = 48, 120
    mats = dft_mats(n, torch.complex64, dev)
    x = torch.randn((b, n, n, n), generator=gen, device=dev,
                    dtype=torch.complex64)
    y_k = axis_dft(x, mats.fwd)
    y_p = axis_dft_plain(x, mats.fwd)
    torch.cuda.synchronize()
    err = max_err(y_k, y_p)
    scale = float(y_p.abs().max())
    del y_k, y_p
    f_k = dft3(x, mats.fwd)
    f_ref = torch.fft.fftn(x, dim=(-3, -2, -1))
    err_f = max_err(f_k, f_ref)
    scale_f = float(f_ref.abs().max())
    del f_ref
    back = dft3(f_k, mats.inv)
    err_b = max_err(back, x)
    scale_b = float(x.abs().max())
    del back, f_k
    ms = cuda_ms(lambda: axis_dft(x, mats.fwd))
    plain_ms = cuda_ms(lambda: axis_dft_plain(x, mats.fwd))
    dft3_ms = cuda_ms(lambda: dft3(x, mats.fwd))
    fft_ms = cuda_ms(lambda: torch.fft.fftn(x, dim=(-3, -2, -1)))
    print(f"phase k2: B={b} N={n} pass max|dy|/scale={err / scale:.3e} "
          f"dft3 fwd vs fftn {err_f / scale_f:.3e} fwd+inv vs x "
          f"{err_b / scale_b:.3e}; one pass: kernel {ms:.3f} ms einsum "
          f"{plain_ms:.3f} ms; 3-D: dft3 (3 kernel passes) {dft3_ms:.3f} ms "
          f"cuFFT fftn {fft_ms:.3f} ms", flush=True)
    if not (err <= 5e-6 * scale and err_f <= 5e-6 * scale_f
            and err_b <= 5e-6 * scale_b):
        fail("K2 disagrees with its plain version / torch.fft (atol "
             "5e-6*scale)")
    return {"name": "axis_dft", "route": "cuda",
            "source": "pcx_torch/kernels/csrc/axis_dft.cu",
            "replaces": "pcx/operators/pallas_kernels.py:288",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "dft3_ms": dft3_ms, "cufft_fftn_ms": fft_ms}


def phase_operator(gen, dev, n: int = N) -> None:
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.operators import maxwell
    from pcx_torch.operators import symbols as sym
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV),
                       device=dev, dtype=torch.complex64)
    alpha = np.array([np.pi, 0.0, 0.0])
    sy = kps.symbols_for(alpha)
    d_a = sym.build_curl(kps.parts, alpha)
    b = sym.penalty(d_a, sy.pnt)
    x = torch.randn((2, 3, n, n, n), generator=gen, device=dev,
                    dtype=torch.complex128)
    y32 = maxwell.ama_bb(x.to(torch.complex64), sy.d_a, sy.b, kps.diel,
                         sy.shift, kps.dft)
    y64 = maxwell.ama_bb(x, d_a, b, kps.diel, sy.shift)
    rel = float(torch.linalg.norm(y32.to(torch.complex128) - y64)
                / torch.linalg.norm(y64))
    print(f"phase operator: N={n} complex64 ama_bb (K2) vs complex128 "
          f"torch.fft: relative error {rel:.3e}", flush=True)
    if not rel <= 1e-5:
        fail("complex64 operator disagrees with complex128 (> 1e-5)")


def golden_row(lattice: str, n: int, index: int):
    path = os.path.join(HERE, "output_c64", "chiral",
                        f"bandgap_{lattice}.json")
    with open(path) as f:
        return np.asarray(json.load(f)[f"{lattice}_{n}_frequencies"][index])


def gate(kps, alpha, res, golden, tag: str) -> str:
    """'' if the solve passes the gates, else why not: status CONVERGED or
    FLOOR, refined |omega - omega_re| <= 1e-3, finite Ritz vectors of the
    block shape, and omega_re within 3.5e-3 of the golden row."""
    from pcx_torch.solvers.lobpcg import Status
    if res.status not in (Status.CONVERGED, Status.FLOOR):
        return f"status {Status(res.status).name}"
    rep = kps.validate_solution(alpha, res, raise_on_spurious=False)
    dev = float(np.abs(rep.omega_pnt - rep.omega_re).max())
    gold = (float(np.abs(rep.omega_re - golden).max())
            if golden is not None else float("nan"))
    ok_x = (tuple(res.x.shape[1:]) == (3,) + (kps.cfg.n,) * 3
            and bool(torch.isfinite(torch.view_as_real(res.x)).all()))
    print(f"  {tag}: status {Status(res.status).name} iters "
          f"{res.iterations} wall {res.wall_time:.3f} s "
          f"({1e3 * res.wall_time / max(res.iterations, 1):.1f} ms/iter) "
          f"max|omega-omega_re| {dev:.3e} max|omega_re-golden| {gold:.3e}",
          flush=True)
    print(f"    omega_re {np.array2string(rep.omega_re, precision=6)}",
          flush=True)
    if rep.spurious or not dev <= SPURIOUS_TOL:
        return f"spurious (max|omega-omega_re| {dev:.3e})"
    if not ok_x:
        return "Ritz vectors not finite or of the wrong shape"
    if golden is not None and not gold <= GOLDEN_TOL:
        return f"omega_re {gold:.3e} from the golden row"
    return ""


def phase_single(dev, n: int = N, golden: bool = True) -> None:
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV),
                       device=dev, dtype=torch.complex64)
    alpha = np.array([np.pi, 0.0, 0.0])
    t0 = time.time()
    res = kps.solve(alpha, seed=0, validate_result=False)
    print(f"phase single: sc_curv N={n} alpha=(pi,0,0) cold solve, "
          f"{time.time() - t0:.3f} s with the plane-wave start", flush=True)
    why = gate(kps, alpha, res, golden_row("sc_curv", n, 19) if golden
               else None, "k=19")
    if why:
        fail(f"single point: {why}")


def phase_warm(dev, n: int = N, golden: bool = True) -> None:
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    kps = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=NEV),
                       device=dev, dtype=torch.complex64)
    path = lattices.k_path("fcc")
    print(f"phase warm: fcc N={n}, cold at k_path index 9, warm at 10, 11",
          flush=True)
    x_prev = None
    for i in (9, 10, 11):
        alpha = path[i]
        gold = golden_row("fcc", n, i) if golden else None
        res = kps.solve(alpha, x0=x_prev, seed=i, validate_result=False)
        kind = "cold" if x_prev is None else "warm"
        why = gate(kps, alpha, res, gold, f"k={i} {kind}")
        if why and x_prev is not None:
            # bench.py's sweep protocol: a rejected warm solve gets one cold
            # retry with a fresh seed, and its time counts for the point.
            print(f"  k={i}: warm solve rejected ({why}, doom "
                  f"{kps.last_doom}); cold retry", flush=True)
            res = kps.solve(alpha, seed=i + 10007, validate_result=False)
            why = gate(kps, alpha, res, gold, f"k={i} cold retry")
        if why:
            fail(f"warm chain k={i}: {why}")
        x_prev = res.x


def main() -> None:
    phase_device()
    import pcx_torch  # noqa: F401  (TF32 off, highest f32 matmul precision)
    phase_build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = [phase_k1(gen, dev), phase_k2(gen, dev)]
    phase_operator(gen, dev)
    from pcx_torch import kernels as kmod
    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    phase_single(dev)
    counts = kmod.launches()
    if not all(counts.values()):
        fail(f"a kernel of the path never launched in the single point: "
             f"{counts}")
    phase_warm(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the solves of phases 6-7; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          f" GiB", flush=True)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    if not all(rec["launches"] > 0 for rec in kernels):
        fail(f"a kernel of the path never launched in the solves: {counts}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
