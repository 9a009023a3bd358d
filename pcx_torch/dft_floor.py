"""Iterations to the complex64 FLOOR under three 3-D DFTs of the operator.

    python3 -m pcx_torch.dft_floor [--dfts kernel,plain,cufft]

Runs the solves of ``chip_smoke.py`` phases 7-8 -- sc_curv N=120 at
alpha=(pi,0,0) cold, and the fcc N=120 chain k_path 9 -> 10 -> 11 (cold,
warm, warm) -- once per DFT of the complex64 operator apply:

* ``kernel``: three K2 passes (a mixed-radix FFT in IEEE f32), the default;
* ``plain``:  three passes of K2's plain version (a cuBLAS f32 einsum with
  the dense DFT matrix);
* ``cufft``:  ``torch.fft.fftn`` / ``ifftn`` in complex64.

For each solve it prints the status, iterations, ms per iteration and
max|omega_re - golden| against the committed ``output_c64`` rows.  A solve
at FLOOR stops where its residual stagnates, so the iteration count there
tells how each DFT's rounding holds the complex64 floor.  Needs a CUDA
device and the repository's ``output_c64/``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVES = (("sc_curv", 19, False), ("fcc", 9, False), ("fcc", 10, True),
          ("fcc", 11, True))


def golden_row(lattice: str, n: int, index: int) -> np.ndarray:
    with open(os.path.join(ROOT, "output_c64", "chiral",
                           f"bandgap_{lattice}.json")) as f:
        return np.asarray(json.load(f)[f"{lattice}_{n}_frequencies"][index])


def use_dft(name: str) -> None:
    """Route the operator's 3-D DFT through ``name``."""
    from pcx_torch.kernels.axis_dft import axis_dft, axis_dft_plain_dir
    from pcx_torch.operators import dft, maxwell

    def dft3_cufft(x, mats, inverse=False):
        fft = torch.fft.ifftn if inverse else torch.fft.fftn
        return fft(x, dim=(-3, -2, -1))

    dft.axis_dft = axis_dft_plain_dir if name == "plain" else axis_dft
    maxwell.dft3 = dft3_cufft if name == "cufft" else dft.dft3


def run(name: str, n: int, dev) -> None:
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    solvers = {lat: KPointSolver(ProblemConfig(n=n, lattice=lat, nev=10),
                                 device=dev, dtype=torch.complex64)
               for lat in ("sc_curv", "fcc")}
    use_dft(name)
    x_prev = None
    for lattice, index, warm in SOLVES:
        kps = solvers[lattice]
        alpha = (np.array([np.pi, 0.0, 0.0]) if lattice == "sc_curv"
                 else lattices.k_path(lattice)[index])
        # the seeds of chip_smoke.py: 0 for the single point, the index
        # for the chain
        res = kps.solve(alpha, x0=x_prev if warm else None,
                        seed=index if lattice == "fcc" else 0,
                        validate_result=False)
        rep = kps.validate_solution(alpha, res, raise_on_spurious=False)
        gold = float(np.abs(rep.omega_re - golden_row(lattice, n, index))
                     .max())
        print(f"  {name:6s} {lattice} k={index} {'warm' if warm else 'cold'}"
              f": status {res.status} iters {res.iterations} "
              f"{1e3 * res.wall_time / max(res.iterations, 1):.1f} ms/iter "
              f"max|omega_re-golden| {gold:.3e}", flush=True)
        x_prev = res.x
    use_dft("kernel")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dfts", default="kernel,plain,cufft")
    ap.add_argument("--n", type=int, default=120)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dft_floor needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}: complex64 solves at N={args.n}"
          f" (status 5 = FLOOR)", flush=True)
    for name in args.dfts.split(","):
        run(name, args.n, dev)


if __name__ == "__main__":
    main()
