"""Rescue stubborn failed k-points of a band library with an escalation
ladder the plain sweep does not use (``tools/rescue_point.py`` of the JAX
package, on the card):

    python -m pcx_torch.rescue_point --n 120 --lattice sc_flat1 \\
        [--diel chiral] [--indices 0 7] [--steps refine64 coarse f64] \\
        [--output output_c64] [--cpu]

The sweep's containment (warm -> cold retry -> supervisor re-seed) heals
transient failures, but some points fail structurally: every complex64
seed stalls with the frequency-error bound above the sweep's 2e-3 (sc_flat1
N=120 k=0; bcc_sg N=120 k=100).  The rungs, cheapest first:

  refine64  the production complex64 solve validated by the complex128
            Rayleigh-Ritz refine (``refine=True``).
  coarse    the two-grid start: converge the k-point on a coarse grid
            (``--coarse-n``, default n // 2), lift it by trigonometric
            interpolation and solve at full resolution
            (``x0_mode="coarse[:nc]"``).
  f64       the whole solve in complex128: the complex64 floor is gone.
            The JAX tool ran it in segments on the TPU (``segment_iters``)
            and it did not fit the v5e's memory at N=120; here it is one
            solve.

Each rung runs ``bandgap(indices=...)`` on the asked rows still failed, so
that checkpointing, validation and recording are the production path's.
The complex64 rungs run in complex128 with ``--cpu``, as the JAX tool does
on the CPU.  Exit 0 only when every asked row is recovered (or there is
nothing to rescue).  Runs on the card unless ``--cpu`` is given; without a
card and without ``--cpu`` the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, NamedTuple, Optional

import torch

from pcx_torch.f64_truth import peak_gib, reset_peak

STEPS = ("refine64", "coarse", "f64")


class Rung(NamedTuple):
    step: str
    todo: list          # the rows it solved
    failed: list        # the rows it left failed
    seconds: float
    peak_gib: float     # peak device memory of the rung (nan on the CPU)


class Rescue(NamedTuple):
    indices: list       # the rows asked for
    rungs: list         # one Rung per rung run
    left: list          # the library's failed rows at the end

    @property
    def ok(self) -> bool:
        return not any(i in self.left for i in self.indices)


def failed_rows(path: str, lattice: str, n: int) -> List[int]:
    """The failed ([-1, -1]) rows of the library at ``path``."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        it = json.load(f).get(f"{lattice}_{n}_iterations") or []
    return [i for i, r in enumerate(it) if r[0] == -1]


def rescue(n: int = 120, lattice: str = "sc_flat1", diel: str = "chiral",
           eps_opt: int = 0, output: str = "output_c64", gap: int = 20,
           nev: int = 10, maxiter: int = 500,
           indices: Optional[list] = None, steps=STEPS, coarse_n: int = 0,
           device="cuda") -> Rescue:
    """Run the ``steps`` of the ladder in order on ``indices`` (default:
    the library's failed rows) until none is left failed."""
    from pcx_torch.bandstructure import _library_path, bandgap

    device = torch.device(device)
    path = _library_path(output, diel, lattice, eps_opt)
    indices = list(indices) if indices else failed_rows(path, lattice, n)
    if not indices:
        print("no failed rows to rescue")
        return Rescue([], [], failed_rows(path, lattice, n))

    c64 = torch.complex128 if device.type == "cpu" else torch.complex64
    coarse = f"coarse:{coarse_n}" if coarse_n else "coarse"
    ladder = {"refine64": (c64, {"refine": True}),
              "coarse": (c64, {"x0_mode": coarse}),
              "f64": (torch.complex128, {})}
    rungs = []
    for step in steps:
        todo = ([i for i in indices if i in set(failed_rows(path, lattice,
                                                               n))]
                if os.path.exists(path) else indices)
        if not todo:
            break
        dtype, solver_kw = ladder[step]
        print(f"# rescue step '{step}' on indices {todo}", flush=True)
        reset_peak(device)
        t0 = time.time()
        err = bandgap(n=n, lattice=lattice, diel_type=diel, eps_opt=eps_opt,
                      output_dir=output, indices=todo, gap=gap, nev=nev,
                      maxiter=maxiter, dtype=dtype, solver_kw=solver_kw,
                      device=device)
        rungs.append(Rung(step, todo, list(err), time.time() - t0,
                          peak_gib(device)))
        print(f"# step '{step}' remaining failures: {err}", flush=True)
    left = failed_rows(path, lattice, n)
    print(f"# rescue done; failed rows now: {left}")
    return Rescue(indices, rungs, left)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.rescue_point",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--lattice", default="sc_flat1")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--output", default="output_c64")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--indices", type=int, nargs="*", default=None,
                    help="k-point indices to rescue (default: the "
                         "library's failed rows)")
    ap.add_argument("--steps", nargs="*", default=list(STEPS),
                    choices=list(STEPS))
    ap.add_argument("--coarse-n", type=int, default=0,
                    help="coarse grid size (default n//2)")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pcx_torch.cli import tool_device
    device = tool_device(args.cpu, ap.prog)
    out = rescue(args.n, args.lattice, args.diel, args.eps_opt, args.output,
                 args.gap, args.nev, args.maxiter, args.indices, args.steps,
                 args.coarse_n, device)
    return 0 if out.ok else 1


if __name__ == "__main__":
    sys.exit(main())
