"""Record a stubborn band-library row by holding a complex64 solve directly
against a committed f64 pin (``tools/record_vs_truth.py`` of the JAX
package, on the card):

    python -m pcx_torch.record_vs_truth --lattice bcc_sg --n 120 --k 100 \\
        [--truth data/bcc_sg_n120_k100_f64.json] [--tries 3] [--cpu]

The sweep rejects a solve whose frequency-error bound exceeds 2e-3.  That is
a bound, not an error: on dense-doublet rows (bcc_sg N=120 k=100) every
complex64 seed stalls with the bound at 5e-3 to 1e-2 while the frequencies
are already accurate.  Where a converged pin exists (``f64_truth``), the
row is recorded iff max |omega - omega_f64| < ``--gate`` (default 1e-3, the
library-wide spurious gate), a stronger test than the bound.

Each try is a complex64 solve with the JAX tool's four levers (lam_tol
2e-6, floor_patience 3, col_patience 3 and w_cap "auto") and seed
1000 + 7 t, validated by the complex128 refine; the tries stop once one is
within gate / 4.  The best try is written into
``<output>/<diel>/bandgap_<lattice><eps_opt>.json`` as one row; a best
deviation at or above the gate writes nothing and exits 1.

A pin of the legacy schema (no lattice, n, diel or eps_opt, as
``data/bcc_sg_k37_f64.json``) reads as bcc_sg, N=120, chiral, preset 0.
Runs on the card unless ``--cpu`` is given; without a card and without
``--cpu`` the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcx_torch.f64_truth import pin_path

LEVERS = {"lam_tol": 2e-6, "floor_patience": 3, "col_patience": 3,
          "w_cap": "auto"}
LEGACY = {"lattice": "bcc_sg", "n": 120, "diel": "chiral", "eps_opt": 0}


def load_truth(path: str, lattice: str, n: int, diel: str = "chiral",
               eps_opt: int = 0) -> dict:
    """The pin at ``path``, with the legacy schema's defaults; raises
    ValueError unless it is converged and of (lattice, n, diel, eps_opt)."""
    with open(path) as f:
        truth = json.load(f)
    for key, val in LEGACY.items():
        truth.setdefault(key, val)
    if truth.get("status", 1) not in (1, 5):
        raise ValueError(f"{path}: the truth must be converged (status 1 "
                         f"or 5), got {truth['status']}")
    want = {"lattice": lattice, "n": n, "diel": diel, "eps_opt": eps_opt}
    other = {k: truth[k] for k in want if truth[k] != want[k]}
    if other:
        raise ValueError(f"{path} is a pin of {other}, not of {want}")
    return truth


class Recorded(NamedTuple):
    deviation: float        # best max |omega - omega_f64| over the tries
    recorded: bool          # whether the row was written
    tries: list             # (status, iterations, wall s, deviation) each
    path: str               # the band library


def record_vs_truth(lattice: str, k: int, n: int = 120, diel: str = "chiral",
                    eps_opt: int = 0, truth: Optional[str] = None,
                    gate: float = 1e-3, tries: int = 3,
                    output: str = "output_c64", device="cuda") -> Recorded:
    """Solve row ``k`` in complex64 up to ``tries`` times and record the
    best try into the band library under ``output`` if it lies within
    ``gate`` of the pin ``truth`` (default ``f64_truth.pin_path``)."""
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver, _library_path
    from pcx_torch.config import ProblemConfig
    from pcx_torch.io import BandLibrary
    from pcx_torch.solvers.lobpcg import Status

    truth = load_truth(truth or pin_path(lattice, n, k), lattice, n, diel,
                       eps_opt)
    want = np.asarray(truth["omega_f64"], float)
    path = lattices.k_path(lattice)
    alpha = path[k]
    if not np.allclose(np.asarray(alpha) / np.pi, truth["alpha_over_pi"],
                       rtol=0, atol=1e-9):
        raise ValueError(f"k={k} is alpha/pi={alpha / np.pi}, the pin's is "
                         f"{truth['alpha_over_pi']}")

    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel,
                        eps_opt=eps_opt, nev=10)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex64,
                          solver_opts=dict(LEVERS))
    best, log = None, []
    for t in range(tries):
        res = solver.solve(alpha, seed=1000 + 7 * t, validate_result=True)
        omega = np.asarray(res.omega_re, float)[: len(want)]
        dev = float(np.abs(omega - want).max())
        log.append((Status(res.status).name, int(res.iterations),
                    float(res.wall_time), dev))
        print(f"# try {t}: status={Status(res.status).name} "
              f"iters={res.iterations} wall={res.wall_time:.1f}s "
              f"max|omega-omega_f64|={dev:.3e}", flush=True)
        if best is None or dev < best[0]:
            best = (dev, omega, res)
        if dev < gate / 4:
            break
    dev, omega, res = best

    lib_path = _library_path(output, diel, lattice, eps_opt)
    if dev >= gate:
        print(f"# REFUSED: best deviation {dev:.3e} >= gate {gate}")
        return Recorded(dev, False, log, lib_path)
    lib = BandLibrary(lib_path, lattice, n, n_k=len(path), nev=10)
    lib.record(k, int(res.iterations), float(res.wall_time), omega)
    print(f"# RECORDED k={k} into {lib_path} "
          f"(max dev vs f64 truth {dev:.3e})")
    return Recorded(dev, True, log, lib_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.record_vs_truth",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--lattice", required=True)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--truth", default=None)
    ap.add_argument("--gate", type=float, default=1e-3)
    ap.add_argument("--tries", type=int, default=3)
    ap.add_argument("--output", default="output_c64")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pcx_torch.cli import tool_device
    device = tool_device(args.cpu, ap.prog)
    out = record_vs_truth(args.lattice, args.k, args.n, args.diel,
                          args.eps_opt, args.truth, args.gate, args.tries,
                          args.output, device)
    return 0 if out.recorded else 1


if __name__ == "__main__":
    sys.exit(main())
