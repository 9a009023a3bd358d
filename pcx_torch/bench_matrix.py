"""The reference's runtime table row by row (``tools/bench_matrix.py`` of
the JAX package, on the card):

    python -m pcx_torch.bench_matrix                       # all 13 rows
    python -m pcx_torch.bench_matrix --rows north_star     # bcc_dg, N=120
    python -m pcx_torch.bench_matrix --rows sc_curv_chiral_100 fcc_chiral_100

Per (lattice, dielectric, N) row: ``python -m pcx_torch.bench --sweep
0``'s protocol in complex64 at alpha = (pi, 0, 0): one untimed cold solve,
``--reps`` timed cold solves (seeds 1, 2, ...) that must end CONVERGED or
FLOOR, and the 1e-3 spurious gate on the last one.  Each row appends one JSON line to ``--out``: the
least wall time (``seconds``), the last iterations, the validation's
max |omega - omega_re|, the RTX-4090 seconds of ``BASELINE.md`` (complex128
on another card) and their ratio, and ``device``, the card's name and power
limit as ``nvidia-smi`` gives them (or ``cpu``).

``--out`` defaults to ``bench_logs/bench_matrix_torch.jsonl`` of the
checkout (git-ignored; ``bench_logs/bench_matrix.jsonl`` holds the JAX
tool's TPU rows).  A rerun skips the rows already in ``--out`` for the same
``device`` and runs the rest.  A failed row is printed and the loop goes
on; the exit code is 1 if any selected row failed.  The solves run on the
card unless ``--cpu`` is given, and without a card and without ``--cpu``
the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from pcx_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "bench_logs", "bench_matrix_torch.jsonl")

# (key, lattice, diel_type, n, baseline_gpu_s) -- BASELINE.md rows.
ROWS = [
    ("bcc_dg_chiral_120", "bcc_dg", "chiral", 120, 44.61),
    ("bcc_dg_pseudo_120", "bcc_dg", "pseudochiral_crossdof", 120, 43.55),
    ("sc_curv_chiral_120", "sc_curv", "chiral", 120, 19.85),
    ("sc_curv_pseudo_120", "sc_curv", "pseudochiral_crossdof", 120, 28.67),
    ("fcc_chiral_120", "fcc", "chiral", 120, 27.71),
    ("fcc_pseudo_120", "fcc", "pseudochiral_crossdof", 120, 34.15),
    ("bcc_sg_chiral_120", "bcc_sg", "chiral", 120, 27.96),
    ("bcc_sg_pseudo_120", "bcc_sg", "pseudochiral_crossdof", 120, 41.08),
    ("sc_curv_chiral_100", "sc_curv", "chiral", 100, 10.79),
    ("sc_curv_pseudo_100", "sc_curv", "pseudochiral_crossdof", 100, 16.67),
    ("fcc_chiral_100", "fcc", "chiral", 100, 16.00),
    ("bcc_dg_chiral_100", "bcc_dg", "chiral", 100, 26.83),
    ("sc_curv_chiral_150", "sc_curv", "chiral", 150, 49.20),
]

ALPHA = bench.ALPHA


def select(rows) -> list:
    """The ROWS named by ``--rows``: ``all``, ``north_star`` (the two
    bcc_dg N=120 rows) or keys."""
    if rows == ["all"]:
        return list(ROWS)
    if rows == ["north_star"]:
        return ROWS[:2]
    return [r for r in ROWS if r[0] in set(rows)]


def done_rows(out: str, device: str) -> set:
    """Keys of the rows in ``out`` measured on ``device``."""
    if not os.path.exists(out):
        return set()
    with open(out) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    return {r["row"] for r in recs if r.get("device") == device}


def run_row(key, lattice, diel, n, baseline, reps, maxiter,
            device="cuda") -> dict:
    """One row's record: ``bench``'s single-point protocol at ALPHA in
    complex64; raises RuntimeError when a timed solve is neither CONVERGED
    nor FLOOR or the last one fails the spurious gate."""
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig

    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel, nev=10)
    solver = KPointSolver(cfg, device=device, dtype=torch.complex64,
                          maxiter=maxiter)
    bench.warm_up(solver, ALPHA, sweep=False)
    points, r = bench.single_protocol(solver, ALPHA, reps)
    if not points or not points[-1]["ok"]:
        raise RuntimeError(f"status {points[-1]['status']}" if points
                           else "no timed solve")
    _, dev = bench.spurious_dev(solver, ALPHA, r)
    if not dev <= bench.SPURIOUS_TOL:
        raise RuntimeError(f"spurious: dev={dev:.2e}")
    value = float(min(p["wall"] for p in points))
    return {"row": key, "lattice": lattice, "diel": diel, "n": n,
            "seconds": round(value, 3), "iters": points[-1]["iters"],
            "validation": float(f"{dev:.3e}"),
            "baseline_gpu_s": baseline,
            "vs_baseline": round(baseline / value, 3),
            "device": bench.device_label(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.bench_matrix",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--rows", nargs="*", default=["all"],
                    help="all (default), north_star or row keys")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pcx_torch.cli import tool_device
    device = tool_device(args.cpu, ap.prog)
    label = bench.device_label(device)
    done = done_rows(args.out, label)
    print(f"device: {label}", flush=True)
    failed = []
    for key, lattice, diel, n, baseline in select(args.rows):
        if key in done:
            print(f"# skip {key} (done)", flush=True)
            continue
        print(f"# === {key} [{time.strftime('%H:%M:%S')}] ===", flush=True)
        try:
            rec = run_row(key, lattice, diel, n, baseline, args.reps,
                          args.maxiter, device)
        except Exception as e:  # noqa: BLE001  a failed row is reported
            print(f"# ROW FAILED {key}: {e}", flush=True)
            failed.append(key)
            continue
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    if failed:
        print(f"# {len(failed)} rows failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
