"""Iteration-tail decomposition of the termination levers
(``tools/iter_tail.py`` of the JAX package, on the card):

    python -m pcx_torch.iter_tail --n 48 --lattice sc_curv --diel chiral

Seed-matched complex64 solves of one configuration at two wave vectors,
(pi, 0, 0) and (pi/3, pi/5, 0), across a matrix of the solver's
termination levers: per variant, one JSON line with the iterations, the
statuses, the validation's max |omega - omega_re| (``val``) and the largest
frequency change against the lever-free ``base``
(``max_domega_vs_base``).  This is the protocol behind the ``lam_tol``
stop (BENCH_NOTES.md, "Iteration-tail decomposition").

The solves take the port's production route (the pair-layout LOBPCG with
K1 and K2 on the card), which stands in for the JAX tool's
``solver_impl="rs", real_boundary=True``; the variants are the JAX
tool's, ``w_cap="auto"`` of ``stack_p3`` and ``stack_lam2e6`` included
(its bucket picked every iteration, ``lobpcg_sep_rs``).  The JAX tool ran on the CPU because the TPU was scarce; this one runs on
the card unless ``--cpu`` is given (complex64 either way), and without a
card and without ``--cpu`` exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

VARIANTS = [
    ("base", {}),
    ("p3", {"floor_patience": 3}),
    ("colp3", {"col_patience": 3}),
    ("stack_p3", {"floor_patience": 3, "col_patience": 3, "w_cap": "auto"}),
    # the complex64 Ritz jitter measured 4e-7 to 1.6e-6 per iteration (N=16
    # sc_curv): lam_tol must sit just above that band to fire
    ("lam2e6", {"lam_tol": 2e-6}),
    ("lam5e6", {"lam_tol": 5e-6}),
    ("stack_lam2e6", {"floor_patience": 3, "col_patience": 3,
                      "w_cap": "auto", "lam_tol": 2e-6}),
]
ALPHAS = (np.array([np.pi, 0.0, 0.0]), np.array([np.pi / 3, np.pi / 5, 0.0]))


def iter_tail(n: int = 48, lattice: str = "sc_curv", diel: str = "chiral",
              nev=None, seed: int = 3, only=None, device="cuda") -> list:
    """Run the variants (all, or those named in ``only``) and print each
    one's JSON line as it ends; returns the records."""
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig

    cfg_kw = dict(n=n, lattice=lattice, diel_type=diel)
    if nev is not None:
        cfg_kw["nev"] = nev
    cfg = ProblemConfig(**cfg_kw)
    variants = VARIANTS if only is None else [
        (name, o) for name, o in VARIANTS if name in set(only)]
    base_omega, records, diel_op = {}, [], None
    for name, opts in variants:
        solver = KPointSolver(cfg, device=device, dtype=torch.complex64,
                              solver_opts=dict(opts), diel=diel_op)
        diel_op = solver.diel
        rec = {"variant": name, "n": n, "lattice": lattice, "diel": diel,
               "iters": [], "status": [], "val": []}
        dmax = 0.0
        for i, alpha in enumerate(ALPHAS):
            r = solver.solve(alpha, seed=seed)
            rec["iters"].append(int(r.iterations))
            rec["status"].append(int(r.status))
            val = (float(np.abs(np.asarray(r.report.omega_pnt)
                                - np.asarray(r.report.omega_re)).max())
                   if r.report is not None else None)
            rec["val"].append(None if val is None else float(f"{val:.2e}"))
            om = np.asarray(r.omega_re)
            if name == "base":
                base_omega[i] = om
            elif i in base_omega:
                dmax = max(dmax, float(np.abs(om - base_omega[i]).max()))
        if name != "base":
            rec["max_domega_vs_base"] = float(f"{dmax:.2e}")
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.iter_tail",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--lattice", default="sc_curv")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--nev", type=int, default=None)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pcx_torch.cli import tool_device
    device = tool_device(args.cpu, ap.prog)
    iter_tail(args.n, args.lattice, args.diel, args.nev, args.seed,
              args.only, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
