"""The complex64 solve next to Gamma and the cost of the two refines.

    python3 -m pcx_torch.near_gamma [--n 120] [--indices 0,1]
        [--diels chiral] [--routes xla,pallas] [--periods rule,8]

Two measurements on the card (sc_curv, nev 10, complex64):

1. The light refine (``refine_light_stats``) against the complex128 refine
   (``refine_stats``) on the block of the cold chiral solve at
   alpha=(pi,0,0): milliseconds per call (synchronized wall clock, median
   of 5 after one warm-up) and the largest difference of their
   frequencies.
2. Cold solves at k_path indices ``--indices`` (next to Gamma: the penalty
   weight (2 pi / |alpha|)^2 is 1600 at index 0) of each dielectric in
   ``--diels``, with each Rayleigh-Ritz Gram route in ``--routes``
   (``rr_gram`` "xla", or "pallas": kernel K3) and each H X / H P refresh
   period in ``--periods`` ("rule": ``bandstructure.refresh_period``; an
   integer: that period, 8 being the JAX solver's): status, iterations,
   seconds, the norm of the tracked residuals at its smallest (and the
   iteration) and at the end, the largest frequency-error bound
   res scal^2 / (8 pi^2 omega) of the complex128 refine (the sweep accepts
   <= 2e-3) and the largest distance from the committed row of output_c64
   (ROADMAP F2).

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from pcx_torch import bandstructure as bs
from pcx_torch import lattices
from pcx_torch.bandstructure import KPointSolver, refresh_period
from pcx_torch.config import ProblemConfig, set_relaxation
from pcx_torch.solvers.lobpcg import Status

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def golden_row(diel_type: str, n: int, index: int) -> np.ndarray:
    with open(os.path.join(ROOT, "output_c64", diel_type,
                           "bandgap_sc_curv.json")) as f:
        return np.asarray(json.load(f)[f"sc_curv_{n}_frequencies"][index])


def _bound(kps, alpha, res) -> tuple:
    """(largest frequency-error bound, the complex128 refine's report)."""
    rep = kps.validate_solution(alpha, res, raise_on_spurious=False)
    om = np.maximum(np.asarray(rep.omega_re, float), 0.05)
    bound = rep.residuals * kps.cfg.scal ** 2 / (8 * np.pi ** 2 * om)
    return float(np.max(bound)), rep


_history = {}


def _recording(solve):
    """``solve`` (the solver ``KPointSolver`` calls), keeping the residual
    history of its last result."""
    def run(*args, **kw):
        res = solve(*args, **kw)
        _history["last"] = res.res_history[:res.iterations + 1]
        return res
    return run


def solves(n: int, diels, indices, routes, periods, dev) -> None:
    bs.lobpcg_sep_rs = _recording(bs.lobpcg_sep_rs)
    path = lattices.k_path("sc_curv")
    for diel_type in diels:
        cfg = ProblemConfig(n=n, lattice="sc_curv", nev=10,
                            diel_type=diel_type)
        diel = None
        for i in indices:
            alpha = path[i]
            _, pnt = set_relaxation(alpha)
            for route in routes:
                for period in periods:
                    opts = {"rr_gram": route}
                    if period != "rule":
                        opts["refresh_every"] = int(period)
                    every = (refresh_period(pnt) if period == "rule"
                             else int(period))
                    kps = KPointSolver(cfg, device=dev, diel=diel,
                                       dtype=torch.complex64,
                                       solver_opts=opts)
                    diel = kps.diel
                    res = kps.solve(alpha, seed=i, validate_result=False)
                    hist = _history["last"]
                    best = int(np.nanargmin(hist))
                    ms = 1e3 * res.wall_time / max(res.iterations, 1)
                    worst, rep = _bound(kps, alpha, res)
                    gold = float(np.abs(rep.omega_re - golden_row(
                        diel_type, n, i)).max())
                    print(f"{diel_type} k_path {i} (pnt {pnt:.1f}) "
                          f"rr_gram={route!r} refresh every {every}: status "
                          f"{Status(res.status).name} iters "
                          f"{res.iterations} wall {res.wall_time:.3f} s "
                          f"({ms:.1f} ms/iter) residual {hist[best]:.2e} at "
                          f"{best}, {hist[-1]:.2e} at the end; max bound "
                          f"{worst:.3e} max|omega_re - committed| "
                          f"{gold:.3e}", flush=True)
                    del kps, res


def _ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.time() - t0))
    return statistics.median(times)


def refines(n: int, dev) -> None:
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=10),
                       device=dev, dtype=torch.complex64)
    alpha = np.array([np.pi, 0.0, 0.0])
    res = kps.solve(alpha, seed=0, validate_result=False)
    light = kps._refine_report(alpha, res.x, mode="light")[0]
    full = kps._refine_report(alpha, res.x, mode="f64")[0]
    ms_light = _ms(lambda: kps.refine_light_stats(alpha, res.x))
    ms_full = _ms(lambda: kps.refine_stats(alpha, res.x))
    print(f"refine of the (pi,0,0) block (m={res.x.shape[0]}, N={n}): light "
          f"{ms_light:.3f} ms, complex128 {ms_full:.3f} ms; "
          f"max|omega_re light - complex128| "
          f"{np.abs(light.omega_re - full.omega_re).max():.3e}, "
          f"max|omega light - complex128| "
          f"{np.abs(light.omega_pnt - full.omega_pnt).max():.3e}",
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--indices", default="0,1")
    ap.add_argument("--diels", default="chiral")
    ap.add_argument("--routes", default="xla,pallas")
    ap.add_argument("--periods", default="rule,8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    refines(args.n, dev)
    solves(args.n, args.diels.split(","),
           [int(i) for i in args.indices.split(",")],
           args.routes.split(","), args.periods.split(","), dev)


if __name__ == "__main__":
    main()
