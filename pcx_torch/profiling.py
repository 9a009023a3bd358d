"""Profiling: the phases of a LOBPCG iteration, read from the program's
spans, and a ``torch.profiler`` trace of any call.

Port of ``pcx/profiling.py``.  The reference prints FFT / RR / MM / LOCK
percentages per iteration from hand-placed synchronized timers
(paper_2/lobpcg.py:478-480, environment.py:84-111); here:

* ``phase_breakdown`` runs a short capped solve under ``torch.profiler``
  and reads the phases from the spans of ``pcx_torch.tracing``: CUDA
  events on the card, the host clock on the CPU;
* ``trace`` runs a callable under ``torch.profiler`` and writes a Chrome
  trace (Perfetto-compatible), in which the program's spans appear;
* ``utils.device_memory_mib`` is the analog of the per-iteration cupy
  memory-pool print (lobpcg.py:471-472).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import torch

from pcx_torch import tracing
from pcx_torch.operators import maxwell
from pcx_torch.utils import block_until_ready, device_memory_mib, generator

LOOP = "pcx.lobpcg"
# phase -> the span that times it inside the solver's loop
PHASES = {"operator_s": "pcx.op", "precond_s": "pcx.precond",
          "ortho_s": "pcx.svqb", "gram_rr_s": "pcx.rr"}


def phase_breakdown(solver, alpha, m: Optional[int] = None, repeats: int = 5,
                    verbose: bool = True) -> Dict[str, float]:
    """Per-iteration phases of a ``KPointSolver``'s LOBPCG at one k-point,
    from one solve capped at ``repeats`` iterations that starts from a
    random (m, 3, N, N, N) block (after a one-iteration warm-up), run under
    ``torch.profiler`` so that the program's spans record.

    Phases (reference print: FFT / RR / MM / LOCK, lobpcg.py:478-480), in
    seconds per iteration of the loop (span ``pcx.lobpcg``):
      operator — the operator applies (``pcx.op``: the solver's DFT, kernel
                 K2 in complex64 on the card, and the dielectric),
      precond  — the residual and preconditioner (``pcx.precond``: kernel
                 K1 on the solver's complex64 route),
      ortho    — the SVQB orthonormalizations of W and P (``pcx.svqb``),
      gram_rr  — the Rayleigh-Ritz step: Gram, small eigenproblem, mixes
                 (``pcx.rr``).
    ``iteration_s`` is the loop's own time per iteration, measured;
    ``memory_mib`` the card's peak allocation (NaN on the CPU).
    """
    m = m or solver.block_width(alpha)
    dev = solver.device
    x = maxwell.random_block(generator(0, dev), solver.cfg.n, m,
                             solver.dtype, dev)
    cap = solver.maxiter
    try:
        solver.maxiter = 1
        solver.solve(alpha, x0=x, validate_result=False)
        solver.maxiter = max(int(repeats), 1)
        before = tracing.totals()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            res = solver.solve(alpha, x0=x, validate_result=False)
        after = tracing.totals()
    finally:
        solver.maxiter = cap
    its = max(int(res.iterations), 1)

    def per_iter(name: str, inside: bool = True) -> float:
        """Seconds per iteration of the spans ``name`` (inside the loop)."""
        ms = 0.0
        for path, (_, _, d) in after.items():
            parts = path.split(tracing.SEP)
            if parts[-1] == name and (not inside or LOOP in parts[:-1]):
                ms += d - before.get(path, (0, 0.0, 0.0))[2]
        return ms / 1e3 / its

    out = {k: per_iter(name) for k, name in PHASES.items()}
    out["iteration_s"] = per_iter(LOOP, inside=False)
    out["memory_mib"] = device_memory_mib()
    if verbose:
        tot = out["iteration_s"]
        print(f"Phase breakdown (N={solver.cfg.n}, m={m}, {solver.dtype}, "
              f"{dev}, {its} iterations):")
        for k in PHASES:
            print(f"  {k:<12} {out[k] * 1e3:8.2f} ms "
                  f"({out[k] / tot * 100:5.1f}% of an iteration)")
        print(f"  iteration    {tot * 1e3:8.2f} ms, "
              f"device memory {out['memory_mib']:.0f} MiB")
    return out


def trace(fn, *args, logdir: Optional[str] = None):
    """Run ``fn(*args)`` under ``torch.profiler`` (the card's activity too
    when there is one) and write its Chrome trace to ``logdir/trace.json``
    (default: ``pcx_trace`` in the temporary directory); returns fn's
    result."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "pcx_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = block_until_ready(fn(*args))
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")
    return out
