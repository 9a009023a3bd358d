"""How many lanes of the lockstep k-point batch fit on the card, by grid.

    python3 -m pcx_torch.lanes_fit [--ns 100 120 150] [--iters 10]
                                   [--max-lanes 16]

For each N, groups of L = 1, 2, ... cold fcc chiral points (k_path index 9
on) go through ``KPointSolver.solve_batch`` in complex64 with the default
options (rr_gram="xla"), cut at ``iters`` iterations (past the first H X /
H P refresh at 8) and validated by the complex128 refine, as a sweep's
group is.  Each group prints one JSON line: N, L, lane-iterations, wall,
ms per lane-iteration and the peak device memory, or ``"fits": false``
when the group ran out of device memory; the first such L ends that N.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

FIRST = 9


def group(n: int, lanes: int, iters: int, dev) -> dict:
    """One cold group of ``lanes`` lanes at grid ``n``: its record."""
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.lattices import k_path
    kps = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=10),
                       device=dev, dtype=torch.complex64, maxiter=iters)
    alphas = [k_path("fcc")[FIRST + j] for j in range(lanes)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = kps.solve_batch(alphas, seed=FIRST, raise_on_spurious=False)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    its = sum(r.iterations for r in res)
    return {"n": n, "lanes": lanes, "fits": True, "lane_iterations": its,
            "wall_s": wall,
            "ms_per_lane_iteration": 1e3 * res[0].wall_time * lanes
            / max(its, 1),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", type=int, nargs="+", default=[100, 120, 150])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--max-lanes", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lanes_fit needs a CUDA device")
    dev = torch.device("cuda", 0)
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "total_gib": total}), flush=True)
    for n in args.ns:
        for lanes in range(1, args.max_lanes + 1):
            oom = False
            try:
                rec = group(n, lanes, args.iters, dev)
            except torch.cuda.OutOfMemoryError:
                oom = True   # measured, not hidden: the record says so
            if oom:
                gc.collect()
                torch.cuda.empty_cache()
                rec = {"n": n, "lanes": lanes, "fits": False}
            print(json.dumps(rec), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            if oom:
                break


if __name__ == "__main__":
    main()
