"""The headline benchmark of the port (``bench.py`` of the JAX package, on
the card):

    python -m pcx_torch.bench                      # fcc N=120, 20 warm points
    python -m pcx_torch.bench --sweep 0            # sc_curv N=120, (pi, 0, 0)
    python -m pcx_torch.bench --n 8 --sweep 3 --cpu

Two protocols, each ending in one JSON line on standard output:

- **Sweep** (``--sweep K``): the mean wall time per k-point of a
  warm-started chain over ``k_path(lattice)[10 + i]``, i < K, entered from
  a cold solve of the path predecessor (index 9) that is re-solved warm
  until its iterations settle (at most two untimed passes).  A point that
  the production sweep's gate rejects (``point_ok``) gets one cold retry
  with seed ``i + 10007``, whose time counts toward the point; more than
  two failed points exit 1.  A device error ends the chain and the metric
  gets the suffix ``_partial``.  The newest accepted point (else the one
  before it) must pass the 1e-3 spurious gate.  Metric
  ``{lattice}_n{N}_sweep_mean_seconds``, with ``points``.
- **Single point** (``--sweep 0``): ``--repeats`` cold solves at
  (pi, 0, 0) with seeds 1, 2, ..., each CONVERGED or FLOOR, the last one
  held to the spurious gate; the value is the least wall time.  Metric
  ``{lattice}_n{N}_kpoint_solve_seconds``.

With no ``--sweep`` and not on the CPU the default is the sweep protocol
over 20 points of fcc N=120 against the reference's 23.12 s/k-point
(``BASELINE.md``), keeping ``--lattice`` and ``--baseline`` where they are
given; otherwise sc_curv N=120 against 19.85 s.  ``vs_baseline`` is the
RTX-4090 seconds over the value (the reference runs complex128 on another
card).  The line's ``device`` is the card's name and power limit as
``nvidia-smi`` gives them, or ``cpu``.

The solves run ``KPointSolver`` with its defaults: complex64 on the card
(kernels K1 and K2; K3 with ``--solver-opt rr_gram=pallas``), complex128
with ``--cpu``.  No termination levers are adopted on their own (the JAX
benchmark took them from TPU A/B records); ``--solver-opt KEY=VAL`` passes
them.  Without a card and without ``--cpu`` the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

from pcx_torch.bandstructure import _is_device_error
from pcx_torch.solvers.lobpcg import Status

SWEEP_START = 10          # path index of the first timed point
RETRY_SALT = 10007        # seed of point i's cold retry: i + RETRY_SALT
MAX_FAILED = 2            # failed sweep points tolerated
SPURIOUS_TOL = 1e-3       # max |omega - omega_re| (validate.recompute)
BOUND_TOL = 2e-3          # frequency-error bound of a MAXITER point
ACCEPTED = (Status.CONVERGED, Status.FLOOR)
ALPHA = np.array([np.pi, 0.0, 0.0])
# the default protocol: the reference's only committed sweep mean
SWEEP_POINTS, SWEEP_LATTICE, SWEEP_BASELINE = 20, "fcc", 23.12
SINGLE_LATTICE, SINGLE_BASELINE = "sc_curv", 19.85


class Sweep(NamedTuple):
    points: list       # one record per point tried, in path order
    completed: list    # (alpha, EigenResult) of the last two accepted points


def _omega(res):
    return (None if res.omega_re is None
            else np.asarray(res.omega_re, float).tolist())


def width_counts(res) -> dict:
    """{width of the W and P blocks: iterations} of a solve (``w_cap``);
    empty where the solver records no widths."""
    if res.widths is None:
        return {}
    w, n = np.unique(res.widths, return_counts=True)
    return {int(a): int(b) for a, b in zip(w, n)}


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def coerce(kv: str) -> tuple:
    """'KEY=VAL' -> (KEY, VAL as int, else float, else str)."""
    k, _, v = kv.partition("=")
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first line), or ``"cpu"``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            return lines[0].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit unknown"


def spurious_dev(solver, alpha, res) -> tuple:
    """(validation report, max |omega - omega_re|) of a finished solve."""
    rep = solver.validate_solution(alpha, res, raise_on_spurious=False)
    return rep, float(np.abs(rep.omega_pnt - rep.omega_re).max())


def point_ok(solver, alpha, res) -> tuple:
    """(accepted, why) by the production sweep's gate: CONVERGED and FLOOR
    pass; MAXITER passes only when its validation is not spurious, within
    1e-3, and every band's frequency-error bound
    res * scal^2 / (8 pi^2 omega) stays within 2e-3 (a warm solve can sit
    at the complex64 floor without the FLOOR rule firing)."""
    if res.status in ACCEPTED:
        return True, ""
    if res.status != Status.MAXITER:
        return False, f"status {Status(res.status).name}"
    rep, dev = spurious_dev(solver, alpha, res)
    if rep.spurious or not np.isfinite(dev) or dev > SPURIOUS_TOL:
        return False, f"MAXITER+spurious (dev {dev:.2e})"
    if rep.residuals is not None:
        om = np.maximum(np.asarray(rep.omega_re, float), 0.05)
        bound = (np.asarray(rep.residuals, float)[: len(om)]
                 * solver.cfg.scal ** 2 / (8.0 * np.pi ** 2 * om))
        if float(np.max(bound)) > BOUND_TOL:
            return False, (f"MAXITER+under-converged "
                           f"(bound {np.max(bound):.2e})")
    return True, "MAXITER accepted (validated at c64 floor)"


def warm_up(solver, alpha, sweep: bool):
    """The untimed cold solve at ``alpha`` (seed 0); in sweep mode then up
    to two warm re-solves from its own result, kept while accepted, ending
    once one takes at most 8 iterations.  Returns the entry result."""
    r = solver.solve(alpha, seed=0, validate_result=False)
    say(f"# warmup: status={Status(r.status).name} iters={r.iterations} "
        f"t={r.wall_time:.2f}s device={solver.device}")
    if not sweep:
        return r
    for dc in range(2):
        if r.x is None:
            break
        r2 = solver.solve(alpha, x0=r.x, validate_result=False)
        say(f"# warmup double-converge pass {dc}: "
            f"status={Status(r2.status).name} iters={r2.iterations} "
            f"t={r2.wall_time:.2f}s")
        if r2.status not in ACCEPTED:
            break   # keep the previous (accepted) subspace
        r = r2
        if r2.iterations <= 8:
            break
    return r


def sweep_protocol(solver, lattice: str, k: int, x0=None) -> Sweep:
    """The timed warm chain over ``k_path(lattice)[(10 + i) % len]``, i < k,
    from the Ritz block ``x0``.  Each point's record: ``i``, ``index``
    (path index), ``status``, ``iters``, ``wall`` (s, a cold retry's
    included), ``omega`` (the Ritz frequencies), ``widths`` (iterations at
    each W/P width, of the accepted or last solve: ``width_counts``),
    ``cold_retry`` and ``ok``.
    Stops at a device error or at the third failed point."""
    from pcx_torch import lattices
    path = lattices.k_path(lattice)
    points, completed = [], []
    x_prev = x0
    for i in range(k):
        index = (SWEEP_START + i) % len(path)
        a = path[index]
        wall, retried = 0.0, False
        try:
            result = solver.solve(a, x0=x_prev, validate_result=False)
            wall += result.wall_time
            ok, why = point_ok(solver, a, result)
            if not ok:
                doom = solver.last_doom
                dtag = (f" [doom-bailed at it={doom[0]}, "
                        f"bound {doom[1]:.2e}]" if doom else
                        f" [{result.iterations} warm iters]")
                say(f"# sweep {i}: warm solve rejected ({why}){dtag}; "
                    f"cold retry")
                x_prev = result = None   # free the warm block first
                retried = True
                result = solver.solve(a, x0=None, seed=i + RETRY_SALT,
                                      validate_result=False)
                wall += result.wall_time
                ok, why = point_ok(solver, a, result)
            elif why:
                say(f"# sweep {i}: {why}")
        except (RuntimeError, OSError) as e:
            if not (isinstance(e, OSError) or _is_device_error(e)):
                raise
            say(f"# DEVICE ERROR at sweep point {i}: {e}")
            break
        points.append({"i": i, "index": index,
                       "status": Status(result.status).name,
                       "iters": int(result.iterations), "wall": wall,
                       "omega": _omega(result),
                       "widths": width_counts(result),
                       "cold_retry": retried, "ok": ok})
        if not ok:
            n_failed = sum(not p["ok"] for p in points)
            say(f"# sweep {i}: FAILED after cold retry ({why}); skipping "
                f"point ({n_failed} failed)")
            x_prev = None
            if n_failed > MAX_FAILED:
                break
            continue
        x_prev = result.x
        completed = (completed + [(a, result)])[-2:]
        say(f"# sweep {i}: {wall:.3f}s, {result.iterations} iters")
    return Sweep(points, completed)


def sweep_validation(solver, completed) -> float:
    """max |omega - omega_re| of the newest accepted point, or of the one
    before it when the newest fails the gate (an isolated spurious point
    does not fail the run); inf when there is none."""
    dev = float("inf")
    for a, res in reversed(completed):
        _, dev = spurious_dev(solver, a, res)
        say(f"# sweep validation: max |omega - omega_re| = {dev:.2e}")
        if dev <= SPURIOUS_TOL:
            break
    return dev


def single_protocol(solver, alpha, repeats: int) -> tuple:
    """``repeats`` cold solves at ``alpha`` with seeds 1, 2, ...; stops at
    the first that is neither CONVERGED nor FLOOR.  Returns (records, last
    result), each record as ``sweep_protocol``'s with ``rep`` for ``i``."""
    points, result = [], None
    for rep in range(repeats):
        result = solver.solve(alpha, seed=rep + 1, validate_result=False)
        ok = result.status in ACCEPTED
        points.append({"rep": rep, "status": Status(result.status).name,
                       "iters": int(result.iterations),
                       "wall": result.wall_time,
                       "omega": _omega(result),
                       "widths": width_counts(result),
                       "cold_retry": False, "ok": ok})
        if not ok:
            say(f"# ERROR: solver status {Status(result.status).name}")
            break
        say(f"# rep {rep}: {result.wall_time:.3f}s, {result.iterations} "
            f"iters, status {Status(result.status).name}")
    return points, result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--lattice", default=None,
                    help=f"default {SINGLE_LATTICE} ({SWEEP_LATTICE} in the "
                         f"default sweep)")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--baseline", type=float, default=None,
                    help=f"reference GPU seconds for this config (default "
                         f"{SINGLE_BASELINE}; {SWEEP_BASELINE} in the default "
                         f"sweep)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--maxiter", type=int, default=500,
                    help="LOBPCG iteration cap")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU in complex128 (default: the card, "
                         "complex64)")
    ap.add_argument("--sweep", type=int, default=None, metavar="K",
                    help="mean time per k-point over a warm-started K-point "
                         "path segment; 0 selects the single point "
                         f"(default: {SWEEP_POINTS} on the card, 0 with "
                         f"--cpu)")
    ap.add_argument("--solver-opt", action="append", default=[],
                    metavar="KEY=VAL",
                    help="extra KPointSolver solver_opts entry (repeatable), "
                         "e.g. --solver-opt floor_patience=3")
    return ap


def run(argv=None) -> tuple:
    """The body of ``main``: (exit code, the JSON record printed last or
    None, the per-point records)."""
    args = parser().parse_args(argv)
    from pcx_torch.cli import tool_device
    device = tool_device(args.cpu, "python -m pcx_torch.bench")
    default_sweep = args.sweep is None and not args.cpu
    if default_sweep:
        args.sweep = SWEEP_POINTS
        if args.lattice is None and args.baseline is None:
            args.lattice, args.baseline = SWEEP_LATTICE, SWEEP_BASELINE
    args.sweep = args.sweep or 0
    args.lattice = args.lattice or SINGLE_LATTICE
    args.baseline = (SINGLE_BASELINE if args.baseline is None
                     else args.baseline)

    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig

    dtype = torch.complex128 if device.type == "cpu" else torch.complex64
    solver_opts = dict(coerce(kv) for kv in args.solver_opt) or None
    if solver_opts is None:
        say("# no termination levers adopted (the solver's defaults); pass "
            "them with --solver-opt KEY=VAL")
    else:
        say(f"# solver_opts: {solver_opts}")
    cfg = ProblemConfig(n=args.n, lattice=args.lattice, diel_type=args.diel,
                        nev=args.nev)
    solver = KPointSolver(cfg, device=device, dtype=dtype,
                          solver_opts=solver_opts, maxiter=args.maxiter)
    label = device_label(device)

    if args.sweep:
        path = lattices.k_path(args.lattice)
        alpha = path[(SWEEP_START - 1) % len(path)]
        r = warm_up(solver, alpha, sweep=True)
        sw = sweep_protocol(solver, args.lattice, args.sweep, x0=r.x)
        n_failed = sum(not p["ok"] for p in sw.points)
        if n_failed > MAX_FAILED:
            say(f"# ERROR: >{MAX_FAILED} failed sweep points")
            return 1, None, sw.points
        times = [p["wall"] for p in sw.points if p["ok"]]
        if not times:
            return 1, None, sw.points
        if sweep_validation(solver, sw.completed) > SPURIOUS_TOL:
            say("# ERROR: spurious eigenvalues")
            return 1, None, sw.points
        value = float(np.mean(times))
        partial = "_partial" if len(sw.points) < args.sweep else ""
        record = {
            "metric": f"{args.lattice}_n{args.n}_sweep_mean_seconds{partial}",
            "value": round(value, 4), "unit": "s", "points": len(times),
            "vs_baseline": round(args.baseline / value, 3), "device": label}
        print(json.dumps(record), flush=True)
        return 0, record, sw.points

    warm_up(solver, ALPHA, sweep=False)
    points, result = single_protocol(solver, ALPHA, args.repeats)
    if not points or not points[-1]["ok"]:
        return 1, None, points
    rep, dev = spurious_dev(solver, ALPHA, result)
    say(f"# validation: max |omega - omega_re| = {dev:.2e} (gate 1e-3): "
        f"omega={np.round(rep.omega_re, 5)}")
    if not dev <= SPURIOUS_TOL:
        say("# ERROR: spurious eigenvalues")
        return 1, None, points
    value = float(min(p["wall"] for p in points))
    record = {"metric": f"{args.lattice}_n{args.n}_kpoint_solve_seconds",
              "value": round(value, 4), "unit": "s",
              "vs_baseline": round(args.baseline / value, 3),
              "device": label}
    print(json.dumps(record), flush=True)
    return 0, record, points


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
