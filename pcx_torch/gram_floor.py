"""The complex64 residual floor of the solvers under three Gram accumulations.

    python3 -m pcx_torch.gram_floor [--grams chunk,wide,c128]

Every Gram of the dense algebra (``rayleigh_ritz.gram_f64`` and ``gram``)
is formed as complex64 GEMM partials summed in complex128.  A GEMM adds
its k dimension in single precision, so the partial's width sets the
rounding error of every Gram, and with it the residual floor of a
complex64 solve.  Three Gram routes:

* ``chunk``: partials of ``rayleigh_ritz.GRAM_CHUNK`` columns (the default);
* ``wide``:  partials of 65536 columns, ``gram`` as one GEMM over all of D
  (the earlier default);
* ``c128``:  both Grams as one complex128 GEMM (the blocks cast up first).

First the error of each route against complex128 and its time (CUDA
events, median of 10) for a (16, 3 N^3) and a (48, 3 N^3) Gram at N=120;
then, under each route, cold complex64 solves of sc_curv chiral: those of
``chip_smoke.py`` at alpha=(pi,0,0), N=32 (nev 6, tol 1e-3, maxiter 200)
with softlock, jd and davidson, and N=120 (nev 10, tol 1e-4, maxiter 300)
with softlock and mixed; and softlock at N=120 at k_path index 1 with
seed 1, next to Gamma, where the solve of ROADMAP F2 stalled.  Each line
gives the status, iterations, seconds and the smallest and last residual
norm.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from pcx_torch.solvers import rayleigh_ritz as rr

C128 = torch.complex128
ROUTE_CHUNK = {"chunk": rr.GRAM_CHUNK, "wide": 65536}
# (N, solver, k_path index; None: alpha=(pi,0,0) with seed 0)
SOLVES = ((32, "softlock", None), (32, "jd", None), (32, "davidson", None),
          (120, "softlock", None), (120, "mixed", None), (120, "softlock", 1))


def _gram_c128(x, y, chunk=0):
    return torch.conj_physical(torch.matmul(x.to(C128), y.to(C128).mH))


def _gram_one(x, y):
    return torch.conj_physical(torch.matmul(x, y.mH))


def use_grams(route: str, base=(rr.gram_f64, rr.gram)) -> None:
    """Route ``rr.gram_f64`` and ``rr.gram`` (every caller looks them up
    on the module) through ``route``."""
    rr.gram_f64, rr.gram = base
    if route == "c128":
        rr.gram_f64 = _gram_c128
        rr.gram = lambda x, y: _gram_c128(x, y).to(x.dtype)
    elif route == "wide":
        rr.gram = _gram_one
    rr.GRAM_CHUNK = ROUTE_CHUNK.get(route, ROUTE_CHUNK["chunk"])


def _ms(fn, reps: int = 10) -> float:
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


def gram_errors(routes, dev, n: int = 120) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d = 3 * n ** 3
    for p in (16, 48):
        x = torch.randn((p, d), dtype=torch.complex64, device=dev,
                        generator=gen)
        y = torch.randn((p, d), dtype=torch.complex64, device=dev,
                        generator=gen)
        ref = _gram_c128(x, y)
        scale = float(ref.abs().max())
        for route in routes:
            use_grams(route)
            for name in ("gram_f64", "gram"):
                fn = getattr(rr, name)
                err = float((fn(x, y).to(C128) - ref).abs().max()) / scale
                print(f"  {route:5s} {name:8s} ({p}, {d}): max rel err "
                      f"{err:.3e}, {_ms(lambda: fn(x, y)):.3f} ms",
                      flush=True)
        del x, y, ref
    use_grams("chunk")


def run(route: str, dev) -> None:
    from pcx_torch import bandstructure as bs
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    last = {}
    wrapped = {}
    for name in ("lobpcg_sep_rs", "davidson_sep", "jd_sep"):
        fn = wrapped[name] = getattr(bs, name)

        def keep(*args, _fn=fn, **kw):
            last["res"] = _fn(*args, **kw)
            return last["res"]
        setattr(bs, name, keep)
    use_grams(route)
    try:
        for n, solver, index in SOLVES:
            alpha = (np.array([np.pi, 0.0, 0.0]) if index is None
                     else lattices.k_path("sc_curv")[index])
            small = n <= 32
            kps = KPointSolver(
                ProblemConfig(n=n, lattice="sc_curv", nev=6 if small else 10),
                device=dev, dtype=torch.complex64, solver=solver,
                tol=1e-3 if small else 1e-4, maxiter=200 if small else 300,
                solver_opts={"rr_gram": "pallas"} if solver == "mixed"
                else None)
            t0 = time.time()
            res = kps.solve(alpha, seed=index or 0, validate_result=False)
            his = last["res"].res_history[:res.iterations]
            where = "(pi,0,0)" if index is None else f"k={index}"
            print(f"  {route:5s} N={n} {where} {solver:8s}: status "
                  f"{res.status} iters {res.iterations} "
                  f"{time.time() - t0:.2f} s, "
                  f"residual min {np.nanmin(his):.3e} last {his[-1]:.3e}",
                  flush=True)
            del kps, res
    finally:
        for name, fn in wrapped.items():
            setattr(bs, name, fn)
        use_grams("chunk")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grams", default="chunk,wide,c128")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gram_floor needs a CUDA device")
    dev = torch.device("cuda", 0)
    routes = args.grams.split(",")
    print(f"{torch.cuda.get_device_name(0)}: Gram routes {routes} "
          f"(status 1 = CONVERGED, 2 = MAXITER, 5 = FLOOR)", flush=True)
    gram_errors(routes, dev)
    for route in routes:
        run(route, dev)


if __name__ == "__main__":
    main()
