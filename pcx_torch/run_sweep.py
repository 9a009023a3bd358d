"""Band-library production runner of the port (``tools/run_sweep.py`` on
the card): the checkpointed band sweep ``pcx_torch.bandstructure.bandgap``
in a worker process under ``pcx_torch.supervisor.supervise``.

The sweep writes its JSON library after every k-point, so a fault costs
exactly the in-flight k-point: the supervisor restarts the worker, which
resumes from the library and retries failed ([-1,-1]) rows, for up to
--max-rounds productive rounds.  The worker runs on the card in complex64
(``--device cuda``, the default) or on the CPU in complex128 (``--device
cpu``), touches the heartbeat file ``$TMPDIR/pcx_hb_<lattice><n>_<diel>.hb``
while it iterates, and validates each point by ``--refine`` (default
``light``: the refine in the iterate's dtype, escalated to the complex128
refine when it rejects).

Usage:
  python -m pcx_torch.run_sweep --n 120 --lattice sc_curv [--diel chiral]
      [--output output_c64] [--gap 20] [--max-rounds 8] [--k-batch 1]
      [--solver-opt rr_gram=pallas] [--refine light|f64|off]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

from pcx_torch.supervisor import SuperviseConfig, supervise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import torch
from pcx_torch.bandstructure import bandgap
device = torch.device({device!r})
err = bandgap(n={n}, lattice={lattice!r}, diel_type={diel!r},
              eps_opt={eps_opt}, output_dir={output!r}, gap={gap},
              dtype=(torch.complex64 if device.type == "cuda"
                     else torch.complex128),
              maxiter={maxiter}, nev={nev}, metrics_path={metrics!r},
              k_batch={k_batch}, solver_opts={solver_opts!r},
              solver_kw={solver_kw!r}, device=device)
sys.exit(2 if err else 0)
"""


def parse_opt(kv: str):
    """'key=val' with val coerced to int/float where possible."""
    k, _, v = kv.partition("=")
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.run_sweep",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--lattice", default="sc_curv")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--output", default="output_c64")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--k-batch", type=int, default=1,
                    help="k-points per solve_batch group on the one device "
                         "(bandgap's k_batch; default 1: one at a time)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the worker: cuda (default) or cpu")
    ap.add_argument("--max-rounds", type=int, default=8,
                    help="budget of PRODUCTIVE rounds (attempts that "
                         "changed the checkpoint)")
    ap.add_argument("--outage-budget", type=float, default=4 * 3600,
                    help="total seconds allowed across no-progress "
                         "attempts (device outage) before giving up")
    ap.add_argument("--stall", type=int, default=900,
                    help="kill the worker if the checkpoint JSON stops "
                         "advancing for this many seconds")
    ap.add_argument("--stall-grace", type=int, default=1800,
                    help="stall allowance before the round's first "
                         "heartbeat or checkpoint write")
    ap.add_argument("--hb-stall", type=int, default=420,
                    help="kill the worker if the heartbeat goes silent "
                         "this long after its first beat")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--solver-opt", action="append", default=[],
                    metavar="KEY=VAL",
                    help="extra KPointSolver solver_opts entry (repeatable),"
                         " e.g. --solver-opt rr_gram=pallas")
    ap.add_argument("--refine", default="light",
                    choices=["light", "f64", "off"],
                    help="per-point validation: 'light' (default; the "
                         "refine in the iterate's dtype, its rejections "
                         "re-validated by the complex128 refine), 'f64' "
                         "(the complex128 refine) or 'off' (the solver's "
                         "own Ritz pairs)")
    args = ap.parse_args(argv)
    if args.k_batch < 1:
        ap.error(f"--k-batch must be at least 1, got {args.k_batch}")
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            ap.error("no CUDA device (torch.cuda.is_available() is False); "
                     "pass --device cpu to run on the CPU")
    solver_opts = dict(parse_opt(kv) for kv in args.solver_opt) or None
    solver_kw = {"refine": {"light": "light", "f64": True,
                            "off": False}[args.refine]}

    suffix = str(args.eps_opt) if args.eps_opt else ""
    path = os.path.join(args.output, args.diel,
                        f"bandgap_{args.lattice}{suffix}.json")
    worker = WORKER.format(root=ROOT, device=args.device, n=args.n,
                           lattice=args.lattice, diel=args.diel,
                           eps_opt=args.eps_opt,
                           output=os.path.abspath(args.output), gap=args.gap,
                           nev=args.nev, maxiter=args.maxiter,
                           k_batch=args.k_batch, metrics=args.metrics,
                           solver_opts=solver_opts, solver_kw=solver_kw)

    hb_path = os.path.join(
        tempfile.gettempdir(),
        f"pcx_hb_{args.lattice}{args.n}_{args.diel}{suffix}.hb")
    env = dict(os.environ, PCX_HEARTBEAT=hb_path)
    cfg = SuperviseConfig(max_rounds=args.max_rounds,
                          outage_budget=args.outage_budget,
                          stall=args.stall, stall_grace=args.stall_grace,
                          hb_path=hb_path, hb_stall=args.hb_stall)
    outcome = supervise(
        lambda: subprocess.Popen([sys.executable, "-u", "-c", worker],
                                 env=env),
        path, args.lattice, args.n, cfg,
        log=lambda msg: print(msg, flush=True))
    if not outcome.ok:
        print(f"# {outcome.status}: pending={outcome.pending}, "
              f"failed={outcome.failed}", file=sys.stderr)
    return 0 if outcome.ok else 1


if __name__ == "__main__":
    sys.exit(main())
