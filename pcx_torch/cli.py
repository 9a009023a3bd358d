"""Command-line launcher of the port (``pcx/cli.py`` with a ``--device``):

    python -m pcx_torch eigen1p --n 32 --lattice sc_curv --alpha 1,0,0
    python -m pcx_torch bandgap --n 120 --lattice sc_flat2 --type chiral
    python -m pcx_torch check   --n 120 --lattice sc_flat2
    python -m pcx_torch plot    --n 120 --lattice sc_curv --out band.png
    python -m pcx_torch devices

Every subcommand but ``devices`` runs on the card (``--device cuda``, the
default) in complex64, the production iterate, or on the CPU with ``--cpu``
(``--device cpu``) in complex128; ``--single`` forces complex64.  Without a
card and without ``--cpu`` the command exits non-zero: nothing falls back
to the CPU.  ``plot`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _parse_alpha(s: str) -> np.ndarray:
    """'1,0,0' (in units of pi) -> the wave vector."""
    return np.array([float(v) for v in s.split(",")]) * np.pi


def _add_common(p):
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--lattice", default="sc_curv")
    p.add_argument("--type", dest="diel_type", default="chiral")
    p.add_argument("--eps-opt", type=int, default=0)
    p.add_argument("--nev", type=int, default=10)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:<i> or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--single", action="store_true",
                   help="complex64 (the default on the card)")


def _setup_device(args):
    """(device, dtype) of the run; exits when the card is asked for and
    there is none."""
    import torch
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("pcx_torch: no CUDA device (torch.cuda.is_available() is "
                 "False); pass --cpu to run on the CPU")
    if args.single or device.type == "cuda":
        return device, torch.complex64
    return device, torch.complex128


def tool_device(cpu: bool, prog: str):
    """The device of a library tool (``python -m pcx_torch.f64_truth`` and
    the other four): the CPU with ``--cpu``, else the card; exits non-zero
    naming the missing card when there is none, so that nothing falls back
    to the CPU."""
    import torch
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA device (torch.cuda.is_available() is "
                 f"False); pass --cpu to run on the CPU")
    return torch.device("cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pcx_torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("eigen1p", help="single k-point solve")
    _add_common(p1)
    p1.add_argument("--alpha", default="1,0,0",
                    help="wave vector in units of pi, e.g. '1,0,0'")

    p2 = sub.add_parser("bandgap", help="full BZ band sweep w/ checkpointing")
    _add_common(p2)
    p2.add_argument("--output", default="output")
    p2.add_argument("--indices", default=None,
                    help="comma-separated k indices (default: resume)")

    p3 = sub.add_parser("check", help="band-library status (resume scan)")
    _add_common(p3)
    p3.add_argument("--output", default="output")

    p4 = sub.add_parser("plot", help="band diagram with gap ratio")
    _add_common(p4)
    p4.add_argument("--output", default="output")
    p4.add_argument("--out", default=None, help="png path")

    sub.add_parser("devices", help="list CUDA devices")

    args = ap.parse_args(argv)

    if args.cmd == "devices":
        import torch
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for i in range(count):
            print(f"cuda:{i} {torch.cuda.get_device_name(i)}")
        if not count:
            print("no CUDA device (torch.cuda.is_available() is False); "
                  "cpu only")
        return 0

    device, dtype = _setup_device(args)
    from pcx_torch.config import MAXITER, TOL

    tol = args.tol if args.tol is not None else TOL
    maxiter = args.maxiter if args.maxiter is not None else MAXITER

    if args.cmd == "eigen1p":
        from pcx_torch.bandstructure import eigen_1p
        res = eigen_1p(args.n, args.lattice, _parse_alpha(args.alpha),
                       device=device, diel_type=args.diel_type,
                       eps_opt=args.eps_opt, nev=args.nev, dtype=dtype,
                       tol=tol, maxiter=maxiter, verbose=True)
        if res.report is not None:
            print(res.report.table())
        return 0 if res.omega is not None else 1

    if args.cmd == "bandgap":
        from pcx_torch.bandstructure import bandgap
        indices = ([int(i) for i in args.indices.split(",")]
                   if args.indices else None)
        err = bandgap(args.n, args.lattice, diel_type=args.diel_type,
                      eps_opt=args.eps_opt, output_dir=args.output,
                      indices=indices, dtype=dtype, tol=tol,
                      maxiter=maxiter, nev=args.nev, device=device)
        return 1 if err else 0

    if args.cmd == "check":
        from pcx_torch.bandstructure import bandgap_history_check
        bandgap_history_check(args.n, args.lattice, diel_type=args.diel_type,
                              eps_opt=args.eps_opt, output_dir=args.output)
        return 0

    if args.cmd == "plot":
        from pcx_torch.plotting import plot_bandgap
        out = args.out or f"band_{args.lattice}_{args.n}.png"
        ratio, _ = plot_bandgap(args.n, args.lattice,
                                diel_type=args.diel_type,
                                eps_opt=args.eps_opt,
                                output_dir=args.output, save_path=out)
        print(f"saved {out} (gap ratio {ratio:.6f})")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
