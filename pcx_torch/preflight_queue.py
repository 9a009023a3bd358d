"""Pre-flight of the library-recovery queue (``tools/preflight_queue.py``
of the JAX package, on the card):

    python -m pcx_torch.preflight_queue [--n 16] [--points 2] [--cpu]

Most queued configurations (the bcc pseudochiral rows, the eps_opt=1
variants, the flats) have no library yet; a latent assembly or naming bug
would waste a full-width run.  This runs each configuration of ``CONFIGS``
through ``bandgap`` at N=16 for 2 k-points in complex128, in a temporary
directory (the worker's code path: checkpoint write, validation gate, warm
start), and prints one OK/FAIL line per configuration with the reference
library that the golden diff would read.  The JAX tool ran on the CPU
because the TPU was scarce; this one runs on the card unless ``--cpu`` is
given, and without a card and without ``--cpu`` exits non-zero.

The reference libraries are looked up under ``$PCX_REFERENCE`` (the
reference checkout's root, holding ``paper_2/output`` and
``paper_1_python/output``); without it, or without the file, the golden
column reads MISSING.  Exit 0 only when every configuration's solve is OK
and its reference library exists, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import NamedTuple, Optional

import torch

# (lattice, diel, eps_opt): the queue minus the configurations already
# produced at reference resolution (sc_curv/fcc chiral) or committed as
# examples (sc_flat1 chiral, sc_curv crossdof).
CONFIGS = [
    ("sc_curv",  "pseudochiral_trivial",  0),
    ("bcc_sg",   "chiral",                0),
    ("bcc_dg",   "chiral",                0),
    ("fcc",      "pseudochiral_crossdof", 0),
    ("fcc",      "pseudochiral_trivial",  0),
    ("bcc_sg",   "pseudochiral_crossdof", 0),
    ("bcc_dg",   "pseudochiral_crossdof", 0),
    ("bcc_sg",   "pseudochiral_trivial",  0),
    ("bcc_dg",   "pseudochiral_trivial",  0),
    ("sc_flat2", "chiral",                0),
    ("sc_curv",  "pseudochiral_crossdof", 1),
    ("sc_curv",  "pseudochiral_trivial",  1),
    ("fcc",      "pseudochiral_crossdof", 1),
    ("fcc",      "pseudochiral_trivial",  1),
]

# pcx flag -> the reference's chiral-file basename (its pseudochiral files
# use the short names for the gyroids).
REF_NAME_CHIRAL = {
    "bcc_sg": "bcc_single_gyroid",
    "bcc_dg": "bcc_double_gyroid",
}


def reference_candidates(lattice: str, n: int, diel: str, eps_opt=None,
                         root: Optional[str] = None) -> list:
    """(path, frequencies-key) candidates of the reference library of a
    queue configuration, most specific first, under ``root`` (default
    ``$PCX_REFERENCE``; no candidates without one).  A copy of
    ``tools/golden_diff.py``'s ``reference_candidates``: eps_opt=0 also
    tries the suffix-less file, since the reference names its preset-0
    chiral libraries both ways (bandgap_sc_flat1.json,
    bandgap_sc_curv0.json)."""
    root = root if root is not None else os.environ.get("PCX_REFERENCE", "")
    if not root:
        return []
    ref = os.path.join(root, "paper_2", "output")
    long = REF_NAME_CHIRAL.get(lattice, lattice)
    bases = [long] + ([lattice] if lattice != long else [])
    if eps_opt is None:
        sufs = ["", "0"]
    elif eps_opt == 0:
        sufs = ["0", ""]
    else:
        sufs = [str(eps_opt)]
    # the file names take the short or the long gyroid form by the diel
    # directory; the frequencies key always takes the long form
    cands = [(os.path.join(ref, diel, f"bandgap_{base}{suf}.json"),
              f"{long}_{n}_frequencies")
             for suf in sufs for base in bases]
    if diel == "chiral" and eps_opt in (None, 0):
        # the paper_1 archive holds complete chiral libraries paper_2
        # lacks (its N=120 rows match paper_2's to 7e-7)
        cands.append((os.path.join(root, "paper_1_python", "output",
                                   f"bandgap_{long}.json"),
                      f"{long}_{n}_frequencies"))
    return cands


def golden_exists(lattice: str, diel: str, eps_opt: int) -> Optional[str]:
    """The basename of the reference library holding the configuration's
    N=120 rows, or None."""
    for path, key in reference_candidates(lattice, 120, diel, eps_opt):
        if os.path.exists(path):
            with open(path) as f:
                if key in json.load(f):
                    return os.path.basename(path)
    return None


class Preflight(NamedTuple):
    lattice: str
    diel: str
    eps_opt: int
    ok: bool            # the solve computed every row and failed none
    computed: int
    bad: list           # failed rows, or the exception raised
    golden: Optional[str]


def preflight(configs=CONFIGS, n: int = 16, points: int = 2,
              device="cuda") -> list:
    """Sweep the first ``points`` rows of each configuration in a temporary
    directory and print its OK/FAIL line; returns one Preflight each."""
    from pcx_torch.bandstructure import _library_path, bandgap

    out = []
    for lattice, diel, eps_opt in configs:
        golden = golden_exists(lattice, diel, eps_opt)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                bandgap(n=n, lattice=lattice, diel_type=diel,
                        eps_opt=eps_opt, output_dir=tmp, gap=20,
                        dtype=torch.complex128, maxiter=300, nev=10,
                        k_batch=1, indices=list(range(points)),
                        device=device)
                with open(_library_path(tmp, diel, lattice,
                                        eps_opt)) as f:
                    it = json.load(f)[f"{lattice}_{n}_iterations"]
                done = [r for r in it if r[0] > 0]
                bad = [r for r in it if r[0] == -1]
                ok = len(done) >= points and not bad
            except Exception as e:  # noqa: BLE001 — report, keep going
                ok, done, bad = False, [], [f"{type(e).__name__}: {e}"]
        print(f"{'OK  ' if ok else 'FAIL'} {lattice:9s} {diel:22s} "
              f"eps{eps_opt} computed={len(done)} bad={bad if bad else 0} "
              f"golden={golden or 'MISSING'}", flush=True)
        out.append(Preflight(lattice, diel, eps_opt, ok, len(done), bad,
                             golden))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcx_torch.preflight_queue",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--points", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pcx_torch.cli import tool_device
    device = tool_device(args.cpu, ap.prog)
    failures = [r for r in preflight(CONFIGS, args.n, args.points, device)
                if not r.ok or r.golden is None]
    if failures:
        print(f"\n{len(failures)} pre-flight failures", flush=True)
        return 1
    print("\nall queue configs pre-flight clean", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
