"""Profiling: a per-phase cost model of one LOBPCG iteration, and a
``torch.profiler`` trace of any call.

Port of ``pcx/profiling.py``.  The reference prints FFT / RR / MM / LOCK
percentages per iteration from hand-placed synchronized timers
(paper_2/lobpcg.py:478-480, environment.py:84-111); here:

* ``phase_breakdown`` times the phases of one iteration standalone over
  repeats, after a warm-up: on the card with CUDA events, on the CPU with
  the host clock;
* ``trace`` runs a callable under ``torch.profiler`` and writes a Chrome
  trace (Perfetto-compatible);
* ``utils.device_memory_mib`` is the analog of the per-iteration cupy
  memory-pool print (lobpcg.py:471-472).
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from typing import Dict, Optional

import torch

from pcx_torch.operators import maxwell
from pcx_torch.operators.blocks import h_block
from pcx_torch.solvers import rayleigh_ritz as rr
from pcx_torch.utils import block_until_ready, device_memory_mib, generator


def _time_call(fn, args, repeats: int, device: torch.device) -> float:
    """Median seconds of ``fn(*args)`` over ``repeats`` runs after one
    warm-up: CUDA events on a card, the host clock on the CPU."""
    block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def phase_breakdown(solver, alpha, m: Optional[int] = None, repeats: int = 5,
                    verbose: bool = True) -> Dict[str, float]:
    """Per-iteration phase cost model of a ``KPointSolver`` at one k-point,
    on a random (m, 3, N, N, N) block in the solver's dtype and device.

    Phases (reference print: FFT / RR / MM / LOCK, lobpcg.py:478-480):
      operator — ``ama_bb`` on the block with the DFT the solver applies
                 (its three-pass DFT, kernel K2 in complex64 on the card; the
                 JAX ``phase_breakdown`` times ``jnp.fft`` here, which its
                 own solver does not run),
      precond  — the zero-FFT block preconditioner ``h_block`` (the
                 solver's complex64 route fuses it with the residual in
                 kernel K1),
      gram_rr  — the complex128-accumulated Gram of [X|X|X] and its
                 ``torch.linalg.eigh`` in complex128,
      update   — one Rayleigh-Ritz mix of the 3m-row block,
      ortho    — Loewdin orthonormalization of the block.
    ``iteration_estimate_s`` = operator + precond + gram_rr + 2 ortho +
    3 update; ``memory_mib`` the card's peak allocation (NaN on the CPU).
    """
    n = solver.cfg.n
    m = m or solver.block_width(alpha)
    dev = solver.device
    sy = solver.symbols_for(alpha)
    x = maxwell.random_block(generator(0, dev), n, m, solver.dtype, dev)
    s3 = torch.cat([x, x, x]).reshape(3 * m, -1)
    ones = torch.ones((3 * m,), dtype=torch.float64, device=dev)
    coeff = torch.eye(3 * m, m, dtype=solver.dtype, device=dev)

    def gram_rr(s):
        return torch.linalg.eigh(rr.hermitize(rr.gram_f64(s, s)))

    out = {
        "operator_s": _time_call(
            lambda v: maxwell.ama_bb(v, sy.d_a, sy.b, solver.diel, sy.shift,
                                     solver.dft), (x,), repeats, dev),
        "precond_s": _time_call(lambda v: h_block(v, sy.inv), (x,), repeats,
                                dev),
        "gram_rr_s": _time_call(gram_rr, (s3,), repeats, dev),
        "update_s": _time_call(rr.mix, (coeff, s3), repeats, dev),
        "ortho_s": _time_call(
            lambda s: rr.masked_loewdin(s[:m], ones[:m], 1e-5)[0], (s3,),
            repeats, dev),
    }
    # One LOBPCG iteration ~ operator + precond + gram_rr + 2*ortho +
    # 6*update-equivalent GEMMs.
    out["iteration_estimate_s"] = (out["operator_s"] + out["precond_s"]
                                   + out["gram_rr_s"] + 2 * out["ortho_s"]
                                   + 3 * out["update_s"])
    out["memory_mib"] = device_memory_mib()
    if verbose:
        tot = out["iteration_estimate_s"]
        print(f"Phase breakdown (N={n}, m={m}, {solver.dtype}, {dev}):")
        for k in ("operator_s", "precond_s", "gram_rr_s", "update_s",
                  "ortho_s"):
            print(f"  {k:<12} {out[k] * 1e3:8.2f} ms "
                  f"({out[k] / tot * 100:5.1f}% of est. iteration)")
        print(f"  est. iteration {tot * 1e3:8.2f} ms, "
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
