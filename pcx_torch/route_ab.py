"""Time the serial solve routes of several checkouts of the repo on one card.

    python3 -m pcx_torch.route_ab TREE [TREE ...] [--n 120] [--iters 24]
                                  [--reps 3] [--cpu]

Each TREE is the root of a checkout (``.`` for this one).  For each, in the
order given, a subprocess imports that checkout's ``pcx_torch`` and solves
the cold fcc chiral point at k_path index 9 (nev=10; complex64 on the card,
complex128 with ``--cpu``) with ``KPointSolver(solver_impl=...)`` on each
route, ``"complex"`` and ``"rs"``, cut at ``iters`` iterations and not validated: one
2-iteration solve first (the libraries' first calls), then ``reps`` timed
solves.  Each prints one JSON line: the tree, the package imported, the
route, the iterations, the ms per iteration of each rep and their median.
Give two trees as A B B A to compare them on one card.  The subprocess
uses only what ``KPointSolver`` has offered since the complex route was
ported, so older checkouts run it too.  Without ``--cpu`` it needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FIRST = 9
IMPLS = ("complex", "rs")


def child(tree: str, n: int, iters: int, reps: int, cpu: bool):
    """In the subprocess: time the routes with ``tree``'s ``pcx_torch``."""
    import numpy as np
    import torch
    import pcx_torch
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.lattices import k_path
    dev = torch.device("cpu" if cpu else "cuda")
    dtype = torch.complex128 if cpu else torch.complex64
    alpha = k_path("fcc")[FIRST]
    for impl in IMPLS:
        def run(maxiter):
            kps = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=10),
                               device=dev, dtype=dtype, maxiter=maxiter,
                               solver_impl=impl)
            return kps.solve(alpha, seed=FIRST, validate_result=False)

        run(2)
        ms, its = [], []
        for _ in range(reps):
            r = run(iters)
            its.append(r.iterations)
            ms.append(1e3 * r.wall_time / max(r.iterations, 1))
        print(json.dumps({"tree": tree, "package": pcx_torch.__file__,
                          "route": impl, "n": n,
                          "iterations": its, "ms_per_iteration": ms,
                          "median_ms": float(np.median(ms))}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.trees[0], args.n, args.iters, args.reps, args.cpu)
        return
    if not args.cpu:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("route_ab needs a CUDA device (or --cpu)")
    for tree in args.trees:
        root = os.path.abspath(tree)
        child_argv = ([root, "--child", "--n", str(args.n), "--iters",
                       str(args.iters), "--reps", str(args.reps)]
                      + (["--cpu"] if args.cpu else []))
        # this file runs in the checkout's root, so its package is the
        # one imported
        cmd = [sys.executable, "-c",
               f"import runpy, sys; sys.argv = {[__file__] + child_argv!r}; "
               f"runpy.run_path({os.path.abspath(__file__)!r}, "
               f"run_name='__main__')"]
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.time()
        subprocess.run(cmd, cwd=root, env=env, check=True)
        print(f"# {tree}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
