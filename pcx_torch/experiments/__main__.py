"""Run an ablation or structural experiment from the command line (the
port of ``python -m pcx.experiments``, with the same names and flags):

    python -m pcx_torch.experiments tol_cmp --n 16 --values 1e-3,1e-5
    python -m pcx_torch.experiments grid_cmp --values 8,12,16
    python -m pcx_torch.experiments check_sdd --n 8
    python -m pcx_torch.experiments precision_test --values 16,32,64
    python -m pcx_torch.experiments pack_cmp --values 32,48

Experiments run on the card, in complex64 (the production iterate) where
the experiment takes a dtype, or on the CPU with ``--cpu``, in complex128.
Without a card and without ``--cpu`` the command exits non-zero: nothing
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

NAMES = ("tol_cmp", "pnt_cmp", "rela_cmp", "scal_cmp", "eps_cmp", "grid_cmp",
         "library_cmp", "global_precision_cmp", "partial_precision_cmp",
         "precision_test", "largek_smooth_cmp", "eigenvector_cmp",
         "largek_cmp", "edge_volume_index_cmp", "dmat_cmp", "check_sdd",
         "check_component_hpd", "bandgap_pseudo_cmp", "compute_extreme_case",
         "pack_cmp")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pcx_torch.experiments",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("name", help="experiment name (see module docstring)")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--lattice", default="sc_curv")
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--alpha", default="1,1,1", help="units of pi")
    ap.add_argument("--values", default=None,
                    help="comma-separated sweep values (tols, Ns, ...)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in complex128")
    ap.add_argument("--output", default="output")
    args = ap.parse_args(argv)
    if args.name not in NAMES:
        print(f"unknown experiment {args.name!r}", file=sys.stderr)
        return 2

    import torch
    if args.cpu:
        device, dtype = torch.device("cpu"), torch.complex128
    else:
        if not torch.cuda.is_available():
            sys.exit("pcx_torch.experiments: no CUDA device "
                     "(torch.cuda.is_available() is False); pass --cpu to "
                     "run on the CPU")
        device, dtype = torch.device("cuda"), torch.complex64

    from pcx_torch.experiments import ablations, precision, runtime, structure

    alpha = np.array([float(v) for v in args.alpha.split(",")]) * np.pi
    vals = args.values.split(",") if args.values else None
    fvals = [float(v) for v in vals] if vals else None
    ivals = [int(float(v)) for v in vals] if vals else None
    dev = {"device": device}
    typed = {"device": device, "dtype": dtype}

    name = args.name
    if name == "tol_cmp":
        ablations.tol_cmp(args.n, args.lattice, fvals or [1e-3, 1e-4, 1e-5],
                          alpha=alpha, nev=args.nev, **typed)
    elif name == "pnt_cmp":
        ablations.pnt_cmp(args.n, args.lattice, fvals or [0.5, 1.0, 2.0],
                          alpha=alpha, nev=args.nev, **typed)
    elif name == "rela_cmp":
        ablations.rela_cmp(args.n, args.lattice, fvals or [0.3, 0.6, 1.0],
                           alpha=alpha, nev=args.nev, **typed)
    elif name == "scal_cmp":
        ablations.scal_cmp(args.n, args.lattice, fvals or [1.0, 2.0],
                           alpha=alpha, nev=args.nev, **typed)
    elif name == "eps_cmp":
        ablations.eps_cmp(args.n, args.lattice, fvals or [5.0, 13.0, 16.0],
                          alpha=alpha, nev=args.nev, **typed)
    elif name == "grid_cmp":
        ablations.grid_cmp(ivals or [8, 16, 24], args.lattice, alpha=alpha,
                           nev=args.nev, **typed)
    elif name == "library_cmp":
        ablations.library_cmp(args.n, args.lattice, alpha=alpha, **dev)
    elif name == "global_precision_cmp":
        precision.global_precision_cmp(args.n, args.lattice, alpha=alpha,
                                       nev=args.nev, **dev)
    elif name == "partial_precision_cmp":
        precision.partial_precision_cmp(args.n, args.lattice, alpha=alpha,
                                        nev=args.nev, **dev)
    elif name == "precision_test":
        precision.precision_test(ivals or (16, 32, 64), args.lattice,
                                 alpha=alpha, nev=args.nev, k=args.k or 5,
                                 **typed)
    elif name == "largek_smooth_cmp":
        precision.largek_smooth_cmp(ivals or (16, 32, 64), k=args.k or 5,
                                    **typed)
    elif name == "eigenvector_cmp":
        structure.eigenvector_cmp(args.n, args.lattice, alpha=alpha,
                                  nev=args.nev, **dev)
    elif name == "largek_cmp":
        structure.largek_cmp(ivals or [32, 64], args.lattice, alpha=alpha,
                             **typed)
    elif name == "edge_volume_index_cmp":
        structure.edge_volume_index_cmp(args.n, args.lattice)
    elif name == "dmat_cmp":
        structure.dmat_cmp(args.n, ("pseudochiral_trivial",
                                    "pseudochiral_crossdof"),
                           lattice=args.lattice, k=args.k, **dev)
    elif name == "check_sdd":
        structure.check_sdd(args.n, k=args.k, lattice=args.lattice,
                            eps_opt=args.eps_opt, **dev)
    elif name == "check_component_hpd":
        structure.check_component_hpd(args.n, k=args.k,
                                      eps_opt=args.eps_opt, **dev)
    elif name == "bandgap_pseudo_cmp":
        structure.bandgap_pseudo_cmp(args.n, args.lattice,
                                     eps_opt=args.eps_opt,
                                     output_dir=args.output)
    elif name == "compute_extreme_case":
        structure.compute_extreme_case(args.n, args.lattice,
                                       output_dir=args.output, **dev)
    elif name == "pack_cmp":
        runtime.pack_cmp(ivals or [32, 48], args.lattice, nev=args.nev,
                         output_path=f"{args.output}/runtime_{args.lattice}"
                                     f".json", **dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
