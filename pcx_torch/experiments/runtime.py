"""Runtime study: single-solve times on the accelerator and on the host CPU.

Port of ``pcx/experiments/runtime.py`` (reference: the pack_cmp / speedup
runs behind paper_2/output/chiral/{runtime,speedup}_sc_curv.json and the
MATLAB run_timecmp.m).  The output schema is the committed JSONs':
``{"<lattice>_<N>": [iters, cpu_s, accel_s, speedup]}``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pcx_torch.bandstructure import KPointSolver
from pcx_torch.config import ProblemConfig

_PI = np.pi


def pack_cmp(ns: Sequence[int] = (100, 120, 150), lattice: str = "sc_curv",
             alpha=None, nev: int = 10, run_cpu: bool = True,
             output_path: Optional[str] = None, verbose: bool = True,
             device="cuda", on_point: Optional[Callable] = None):
    """Accelerator-vs-CPU single-solve timing table
    (reference: runtime_sc_curv.json / speedup_sc_curv.json).

    On ``device`` each N takes a warm-up solve (seed 0) and the timed one
    (seed 1), both unvalidated: on the card the production complex64
    solve (kernels K1 and K2), on the CPU complex128.  The solver's wall
    time synchronizes the card at both ends.  ``run_cpu`` adds the
    complex128 solve on the CPU (seed 1).  ``on_point(n, solver, result)``,
    when given, receives each timed accelerator solve.
    """
    if alpha is None:
        alpha = np.array([_PI, _PI, _PI])
    device = torch.device(device)
    dtype = torch.complex64 if device.type == "cuda" else torch.complex128
    results = {}
    for n in ns:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
        solver = KPointSolver(cfg, device=device, dtype=dtype)
        solver.solve(alpha, seed=0, validate_result=False)
        fast = solver.solve(alpha, seed=1, validate_result=False)
        if on_point is not None:
            on_point(n, solver, fast)

        cpu_s = float("nan")
        if run_cpu:
            solver_cpu = KPointSolver(cfg, device="cpu",
                                      dtype=torch.complex128)
            cpu_s = solver_cpu.solve(alpha, seed=1,
                                     validate_result=False).wall_time

        results[f"{lattice}_{n}"] = [
            int(fast.iterations), cpu_s, fast.wall_time,
            (cpu_s / fast.wall_time) if run_cpu else float("nan"),
        ]
        if verbose:
            print(f"N = {n}: iters = {fast.iterations}, "
                  f"accel = {fast.wall_time:<6.2f}s, cpu = {cpu_s:<6.2f}s, "
                  f"speedup = {results[f'{lattice}_{n}'][3]:<6.2f}x")

    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(results, f, indent=4)
    return results
