"""A converged complex128 solve of one k-point, written as an "f64 pin"
(``tools/f64_truth.py`` of the JAX package, on the card):

    python -m pcx_torch.f64_truth --lattice bcc_sg --n 120 --k 37
    python -m pcx_torch.f64_truth --lattice bcc_sg --n 24 --k 37 --cpu

A pin holds a library row to the frequencies of a converged complex128
solve at the same discretization (tests/test_bandstructure.py
``test_library_rows_match_f64_ground_truth``); ``record_vs_truth`` records
a stubborn row against one.  The record is the committed pins' schema with
their rounding: lattice, n, diel, eps_opt, k, alpha_over_pi (1e-10),
status, iters, seconds (0.1 s), tol, omega_f64 (1e-8), written to
``--out`` (default ``data/{lattice}_n{N}_k{K}_f64.json`` of the checkout)
only when the solve ends CONVERGED or FLOOR.

The solve runs on the card unless ``--cpu`` is given, in complex128 on
either device; the port's kernels are complex64-only, so none launches and
the operator's DFT is the complex128 einsum of ``operators/dft.py``.
Without a card and without ``--cpu`` the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


def pin_path(lattice: str, n: int, k: int) -> str:
    """The default path of the pin of (lattice, N, k) in the checkout."""
    return os.path.join(DATA, f"{lattice}_n{n}_k{k}_f64.json")


class Truth(NamedTuple):
    record: dict       # the pin's JSON record
    result: object     # the solve's bandstructure.EigenResult
    peak_gib: float    # peak device memory of the solve (nan on the CPU)


def peak_gib(device) -> float:
    """Peak device memory in GiB since the last reset, nan on the CPU."""
    if torch.device(device).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def f64_truth(lattice: str = "bcc_sg", n: int = 120, k: int = 0,
              diel: str = "chiral", eps_opt: int = 0, tol: float = 1e-7,
              maxiter: int = 1500, nev: int = 10, device="cuda") -> Truth:
    """Solve k_path(lattice)[k] in complex128 (seed 0, validated by the
    complex128 refine) and return its pin record, the result and the peak
    device memory."""
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig

    alpha = lattices.k_path(lattice)[k]
    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel,
                        eps_opt=eps_opt, nev=nev)
    reset_peak(device)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex128,
                          tol=tol, maxiter=maxiter)
    t0 = time.time()
    res = solver.solve(alpha, seed=0, validate_result=True)
    dt = time.time() - t0
    omega = np.asarray(res.omega_re, float)
    rec = {
        "lattice": lattice, "n": n, "diel": diel, "eps_opt": eps_opt,
        "k": k, "alpha_over_pi": [round(float(a) / np.pi, 10) for a in alpha],
        "status": int(res.status), "iters": int(res.iterations),
        "seconds": round(dt, 1), "tol": tol,
        "omega_f64": [round(float(w), 8) for w in omega],
    }
    return Truth(rec, res, peak_gib(device))


def write_pin(record: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.f64_truth",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--lattice", default="bcc_sg")
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--k", type=int, required=True,
                    help="k-point index on the lattice's standard path")
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--maxiter", type=int, default=1500)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pcx_torch.cli import tool_device
    from pcx_torch.solvers.lobpcg import Status
    device = tool_device(args.cpu, ap.prog)
    truth = f64_truth(args.lattice, args.n, args.k, args.diel, args.eps_opt,
                      args.tol, args.maxiter, args.nev, device)
    rec, res = truth.record, truth.result
    omega = np.asarray(rec["omega_f64"])
    print(f"# status={Status(res.status).name} iters={res.iterations} "
          f"t={rec['seconds']:.1f}s omega={omega}", flush=True)
    print(f"# peak device memory {truth.peak_gib:.2f} GiB on {device}"
          if device.type == "cuda" else "# peak device memory: not "
          "measured (CPU)", flush=True)
    if res.status not in (Status.CONVERGED, Status.FLOOR):
        print("# NOT converged — refusing to write a pin", file=sys.stderr)
        return 1
    out = args.out or pin_path(args.lattice, args.n, args.k)
    write_pin(rec, out)
    print(f"# wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
