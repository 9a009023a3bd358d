"""One run of one cell: set-up, the measured window, the trace, the check
against the reference, and the result line.

``BENCHMARK.json`` names the cell; its configuration, traffic mix, limits
and metric readers are files found by name (see ``benchmark/__init__``).
The window drives ``pcx_torch.bandstructure.KPointSolver.solve``, built as
the production runner builds it (the configuration's iterate and refine,
``solver_opts`` only where the mix names them), through the sweep logic of
``chain``.  It runs whole passes of the mix and closes at the first pass
boundary at or after ``seconds``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from typing import NamedTuple, Optional

import torch

from benchmark import chain, trace as tr, traffic
from benchmark.reference import control as ctl, maxwell as ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pcx")   # top-level module names
WARMUP_ITERS = 8      # the capped set-up solve of a cold cell


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


class Cell(NamedTuple):
    name: str
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<traffic>.json
    limits: dict          # {number: limit}: the configuration's stated
                          # guarantees and limits/<cell>.json
    metrics: list         # BENCHMARK.json entries this run reports
    chips: int


def cell(name: str, traced: bool, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with the metrics a run of
    it reports: the end-to-end ones untraced, the per-layer ones traced,
    each where it lists the cell or lists no cells."""
    bench = bench or spec()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = [m for m in bench["per_layer" if traced else "end_to_end"]
               if name in m.get("workloads", [name])]
    cfg = load_json(ROOT, conf["file"])
    return Cell(name, cfg,
                traffic.load(w["traffic"]),
                {**cfg["guarantees"],
                 **load_json(HERE, "limits", f"{name}.json")}, metrics,
                int(w["chips"]))


def reader(metric: str):
    """The reader module of a metric: ``metrics/<name up to the first
    dot>.py``, whose ``read(run)`` returns a number or None."""
    base = metric.split(".")[0]
    path = os.path.join(HERE, "metrics", f"{base}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{base}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Run(NamedTuple):
    """What a run measured, as the metric readers see it."""
    points: list          # chain.PointRecord of every k-point attempted
    window_s: float       # host clock, the card synchronised at both ends
    setup_s: float
    peak_bytes: int       # the window's peak allocation
    trace: Optional[tr.Trace]
    launches: dict        # pcx_torch.kernels.launches() over the window
    k2_by_batch: dict     # pcx_torch.kernels.k2_launches_by_batch()
    n: int
    block_width: int

    @property
    def iterations(self) -> int:
        return sum(p.iterations for p in self.points)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: the solver of a cell, built once."""

    def __init__(self, c: Cell, device):
        from pcx_torch.bandstructure import KPointSolver
        from pcx_torch.config import ProblemConfig
        cfg = c.config
        self.device = device
        self.solver = KPointSolver(
            ProblemConfig(n=cfg["n"], lattice=cfg["lattice"],
                          diel_type=cfg["diel_type"], eps_opt=cfg["eps_opt"],
                          nev=cfg["nev"]),
            device=device, dtype=getattr(torch, cfg["iterate"]),
            tol=cfg["tol"] / cfg["scal"] ** 2, maxiter=cfg["maxiter"],
            solver_opts=dict(c.mix.get("solver_opts", {})) or None,
            refine=cfg["refine"])

    def warm(self, plan: traffic.Plan):
        """Set-up's solves: the entry block of a warm chain, or a short
        capped cold solve of the cell's first point; then the light refine
        and the complex128 refine of the escalation on its block.  Returns
        the entry result (None for cold traffic)."""
        s = self.solver
        if plan.entry is not None:
            r = chain.entry_block(s, plan.entry, plan.settle_passes,
                                  plan.settle_iters)
            p = plan.entry
        else:
            p = plan.points[0]
            cap, s.maxiter = s.maxiter, WARMUP_ITERS
            try:
                r = s.solve(p.alpha, seed=p.seed, validate_result=False)
            finally:
                s.maxiter = cap
        s.validate_solution(p.alpha, r, raise_on_spurious=False)
        chain.f64_report(s, p.alpha, r.x)
        return r if plan.entry is not None else None


class Keeper:
    """Host copies of the blocks kept for the check.  On the card each copy
    goes, without a host sync, into a pinned buffer set aside in set-up
    (two passes' worth; a further one is pinned when needed), so that
    keeping a block costs the window one DMA transfer."""

    def __init__(self, count: int, shape, dtype, device):
        self.pin = device.type == "cuda"
        self.free = [self._buffer(shape, dtype) for _ in range(count)] \
            if self.pin else []

    def _buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin)

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        if not self.pin:
            return x.detach().clone()
        buf = self.free.pop() if self.free else self._buffer(x.shape,
                                                               x.dtype)
        return buf.copy_(x.detach(), non_blocking=True)


def window(prog: Program, plan: traffic.Plan, entry, seconds: float,
           traced: bool, keeper: Keeper) -> tuple:
    """Whole passes of the plan until ``seconds`` have gone by at a pass
    boundary.  Returns (records, wall seconds, Trace or None)."""
    device = prog.device
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    records, passes, ends = [], 0, []
    _sync(device)
    with torch.profiler.record_function(tr.WINDOW) if traced \
            else contextlib.nullcontext():
        t0 = time.time()
        while True:
            keep = traffic.checked(plan, passes)
            carry = [entry.x] if entry is not None else []
            for j, p in enumerate(plan.points):
                rec, res = chain.solve_point(prog.solver, p, carry,
                                             retry=entry is not None)
                if res is not None:
                    if entry is not None:
                        carry.append(res.x)
                    if j in keep or rec.escalated or rec.retried:
                        rec.x = keeper.keep(res.x)
                records.append(rec)
                del res
            passes += 1
            _sync(device)
            wall = time.time() - t0
            ends.append(wall)
            if wall >= seconds:
                break
    trace = None
    if traced:
        t1 = time.time()
        prof.__exit__(None, None, None)
        trace = tr.from_profiler(prof)
        del prof
        say(f"# trace: {len(trace.device)} device and {len(trace.host)} "
            f"host events, read in {time.time() - t1:.1f} s")
    for r in records:
        say(f"# k-point {r.index}: {r.iterations} iterations, "
            f"{'accepted' if r.ok else 'FAILED ' + r.why}"
            f"{', escalated' if r.escalated else ''}"
            f"{', cold retry' if r.retried else ''}")
    say(f"# window: {passes} pass(es), {len(records)} k-points, "
        f"{wall:.3f} s; passes ended at "
        + ", ".join(f"{t:.3f}" for t in ends) + " s")
    return records, wall, trace


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def check(c: Cell, records: list, device, use_control: bool = False
          ) -> dict:
    """The comparison with the reference: every kept block, each number
    its widest over them.  Returns {number: (value, limit)}."""
    diel = ref.Dielectric(c.config, device)
    worst = dict.fromkeys(ref.Readings._fields, 0.0)
    kept = [r for r in records if r.x is not None]
    for r in kept:
        op = ref.Operator(c.config, diel, r.alpha, device)
        x = r.x.to(device)
        if use_control:
            omega, omega_re, x = ctl.answer(c.config, op, x)
        else:
            omega, omega_re = r.omega, r.omega_re
        got = ref.judge(c.config, op, x, omega, omega_re)
        for k, v in got._asdict().items():
            worst[k] = max(worst[k], v)
        del x, op
    out = {k: (v, float(c.limits[k])) for k, v in worst.items()}
    out["checked"] = (len(kept), 1)
    out["failed"] = (sum(not r.ok for r in records), 0)
    return out


def passed(checks: dict) -> bool:
    return all((v >= lim) if k == "checked" else (v <= lim)
               for k, (v, lim) in checks.items())


def run_cell(c: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> tuple:
    """Set-up, window, check.  Returns (result dict, check lines)."""
    from pcx_torch import kernels
    plan = traffic.plan(c.mix, c.config, seed)
    prog = Program(c, device)
    width = prog.solver.block_width(plan.points[0].alpha)
    if width != c.config["block_width"]:
        raise ValueError(f"block width {width}, configuration "
                         f"{c.config['block_width']}")
    entry = prog.warm(plan)
    n = c.config["n"]
    keeper = Keeper(2 * plan.check_per_pass, (width, 3, n, n, n),
                    getattr(torch, c.config["iterate"]), device)
    cuda = device.type == "cuda"
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    setup_s = time.time() - t_start
    records, wall, trace = window(prog, plan, entry, seconds, traced, keeper)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = kernels.launches()
    k2 = kernels.k2_launches_by_batch()
    del entry, prog, keeper
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.time()
    checks = check(c, records, device)
    say(f"# reference: {checks['checked'][0]} k-points in "
        f"{time.time() - t0:.1f} s")
    run = Run(records, wall, setup_s, peak, trace, launches, k2,
              c.config["n"], width)
    metrics = {}
    for m in c.metrics:
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(max(peak, setup_peak))}
    result = {"correct": passed(checks), "attempted": len(records),
              "failed": checks["failed"][0], "metrics": metrics,
              "device": dev}
    if trace is not None:
        dev["busy_s"] = tr.busy_s(trace)
        dev["window_s"] = tr.window_s(trace)
        result["breakdown"] = tr.breakdown(trace)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    lines = [f"check {k}: {v!r} (limit {lim!r}, "
             f"{'at least' if k == 'checked' else 'at most'})"
             for k, (v, lim) in checks.items()]
    return result, lines
