"""Where one LOBPCG solve spends the card's time, by kernel family.

    python3 -m pcx_torch.profile_solve [--n 120] [--iters 16] [--index 9]
                                       [--lanes 1]

Runs a cold complex64 fcc solve at ``lattices.k_path("fcc")[index]``,
capped at ``iters`` iterations, once per Rayleigh-Ritz route
(``rr_gram="xla"``: the stacked Gram; ``"pallas"``: kernel K3 and the
blockwise update) under ``torch.profiler``, after one short unprofiled solve
that builds the kernels and warms the libraries.  For each route it prints
the wall time, the device time of all kernels and copies, the device's busy
share, ms per iteration and peak device memory, then the device time by
kernel family; last, the per-iteration difference of each family between
the two routes.  With ``--lanes L`` (L > 1) each route solves the L points
from ``index`` on as one lockstep group (``KPointSolver.solve_batch``), and
the per-iteration numbers are per lane-iteration.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

# (family, substrings of the device event's name), first match wins
FAMILIES = (
    ("K2 axis_dft", ("axis_dft_kernel",)),
    ("K3 gram9", ("gram9_partial_kernel", "gram9_reduce_kernel")),
    ("K1 resid_precond", ("resid_precond_kernel", "column_sum_kernel")),
    ("cuBLAS GEMMs", ("gemm", "gemv", "cutlass", "xmma", "cublas", "dot_")),
    ("linalg (eigh, cuSOLVER)", ("syev", "heev", "cusolver", "lapack",
                                 "potr", "trsm", "geqr", "orgqr")),
    ("cat / stack copies", ("CatArray", "cat_", "stack")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("memcpy / memset", ("Memcpy", "Memset", "memcpy", "memset")),
    ("eager elementwise", ("elementwise", "Elementwise")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def run(kps, alphas):
    """One solve of ``alphas`` (one point: ``solve``, else a lockstep
    group); returns the lane-iterations."""
    if len(alphas) == 1:
        return kps.solve(alphas[0], seed=0, validate_result=False).iterations
    return sum(r.iterations for r in kps.solve_batch(
        alphas, seed=0, validate_result=False))


def profile_route(kps, alphas, route: str, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    kps.solver_opts["rr_gram"] = route
    kps.maxiter = iters
    dev = kps.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        its = run(kps, alphas)
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
    by = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = by[family(evt.name)]
        fam[0] += evt.time_range.elapsed_us() / 1e3
        fam[1] += 1
    return {"route": route, "wall_ms": 1e3 * wall, "iters": its,
            "device_ms": sum(v[0] for v in by.values()),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "families": dict(by)}


def report(r: dict) -> None:
    it = max(r["iters"], 1)
    print(f"rr_gram={r['route']!r}: {r['iters']} iterations, wall "
          f"{r['wall_ms']:.1f} ms ({r['wall_ms'] / it:.2f} ms/iter), device "
          f"{r['device_ms']:.1f} ms, busy {100 * r['device_ms'] / r['wall_ms']:.1f}%"
          f", peak memory {r['peak_gib']:.2f} GiB", flush=True)
    print(f"  {'family':26s} {'ms':>9s} {'share':>7s} {'ms/iter':>8s} "
          f"{'launches':>8s}", flush=True)
    for fam, (ms, n) in sorted(r["families"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:26s} {ms:9.2f} {100 * ms / r['device_ms']:6.1f}% "
              f"{ms / it:8.3f} {n:8d}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--index", type=int, default=9)
    ap.add_argument("--lanes", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs a CUDA device")
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    dev = torch.device("cuda", 0)
    kps = KPointSolver(ProblemConfig(n=args.n, lattice="fcc", nev=10),
                       device=dev, dtype=torch.complex64, maxiter=2)
    alphas = [np.asarray(lattices.k_path("fcc")[args.index + j])
              for j in range(args.lanes)]
    for route in ("xla", "pallas"):   # build the kernels, warm the libraries
        kps.solver_opts["rr_gram"] = route
        run(kps, alphas)
    print(f"fcc N={args.n} k_path[{args.index}] cold complex64 solve, "
          f"{args.iters} iterations, {args.lanes} lane(s); "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    runs = [profile_route(kps, alphas, route, args.iters)
            for route in ("xla", "pallas")]
    for r in runs:
        report(r)
    xla, pal = runs
    fams = sorted(set(xla["families"]) | set(pal["families"]))
    print("per iteration, 'pallas' minus 'xla' (ms):", flush=True)
    for fam in fams:
        a = xla["families"].get(fam, [0.0, 0])[0] / max(xla["iters"], 1)
        b = pal["families"].get(fam, [0.0, 0])[0] / max(pal["iters"], 1)
        print(f"  {fam:26s} {b - a:+8.3f}", flush=True)


if __name__ == "__main__":
    main()
