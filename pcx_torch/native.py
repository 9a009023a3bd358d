"""The native (C++/OpenMP) mask engine: a ctypes binding of the port's copy
of pcx's geometry engine, ``pcx_torch/csrc/pcx_geometry.cpp`` (port of
``pcx/native.py``).

The engine evaluates the lattice flag predicates over the 3N^3 edge DoFs or
the N^3 cell centres on all host cores (reference cold path:
dielectric.py:84-87), where numpy evaluates them one broadcast grid at a
time.  ``geometry.edge_mask``/``volume_mask`` call it by default
(``use_native=True``); its masks are bit-identical to numpy's, so the two
engines share the mask cache.

g++ builds the library at first use, or by ``python -m pcx_torch.native
--build``, into ``pcx_torch/_build/`` under a name keyed by a hash of the
source and the flags: an edited source rebuilds, an unchanged one loads.
The build takes OpenMP where the compiler has it; a g++ without its
OpenMP runtime (no ``libgomp.spec``, as on some of the card's machines)
builds the same engine single-threaded, named ``libpcxgeom_serial_*``,
with the same bits.  Each build writes into a temporary directory and
renames the library into place, so that processes building at once never
load half a file.  A build that fails with and without OpenMP raises with
the compiler's output; ``use_native=False`` is how a caller asks for
numpy instead.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "pcx_geometry.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-std=c++17",
             "-shared")
OPENMP = "-fopenmp"

# Flag ids of the C++ engine (its FlagId enum).
FLAG_IDS = {
    "sc_flat1": 0,
    "sc_flat2": 1,
    "sc_curv": 2,
    "bcc_sg": 3,
    "bcc_dg": 4,
    "fcc": 5,
}


def cxx() -> str:
    """The C++ compiler: $CXX, else g++ on PATH."""
    cand = os.environ.get("CXX") or shutil.which("g++")
    if not cand:
        raise RuntimeError("no C++ compiler ($CXX or g++) for the native "
                           "mask engine; pass use_native=False for numpy")
    return cand


def library_path(src: str = SOURCE, build_dir: str = BUILD_DIR,
                 openmp: bool = True) -> str:
    flags = CXX_FLAGS + ((OPENMP,) if openmp else ())
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    kind = "omp" if openmp else "serial"
    return os.path.join(build_dir,
                        f"libpcxgeom_{kind}_{h.hexdigest()[:16]}.so")


def build(src: str = SOURCE, build_dir: str = BUILD_DIR,
          verbose: bool = False) -> str:
    """Compile the library unless a build of the same source and flags
    exists, with OpenMP or, where the compiler cannot link it, without;
    returns its path.  Raises with the compiler's output when both fail."""
    errors = []
    for openmp in (True, False):
        path = library_path(src, build_dir, openmp)
        if os.path.exists(path):
            return path
        os.makedirs(build_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            out = os.path.join(tmp, "lib.so")
            cmd = [cxx(), *CXX_FLAGS, *((OPENMP,) if openmp else ()), "-o",
                   out, src]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            if verbose:
                print(" ".join(cmd), r.stdout, r.stderr, sep="\n")
            if r.returncode == 0:
                os.replace(out, path)
                return path
            errors.append(f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    raise RuntimeError(f"native mask engine: {cmd[0]} failed:\n"
                       + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def load(path: Optional[str] = None) -> ctypes.CDLL:
    """Load the library at ``path`` (default: build it, if needed) with
    every entry point's signature declared."""
    lib = ctypes.CDLL(path or build())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f8p = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.pcx_edge_mask, lib.pcx_volume_mask):
        fn.argtypes = [ctypes.c_int, ctypes.c_int, f8p, u8p]
        fn.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the engine builds (or is built) and loads here.  Only this
    question swallows the build's error: ``use_native=True`` raises it."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _mask(entry: str, shape, n: int, lattice: str, ct_inv_t,
          lib: Optional[ctypes.CDLL]) -> np.ndarray:
    if lattice not in FLAG_IDS:
        raise ValueError(f"the native mask engine has no lattice "
                         f"{lattice!r}; known: {sorted(FLAG_IDS)}")
    m = np.ascontiguousarray(ct_inv_t, dtype=np.float64)
    if m.shape != (3, 3):
        raise ValueError(f"ct_inv_t must be 3x3, got {m.shape}")
    out = np.empty(int(np.prod(shape)), dtype=np.uint8)
    rc = getattr(lib or load(), entry)(
        n, FLAG_IDS[lattice],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"{entry}(n={n}, {lattice!r}) returned {rc}")
    return out.reshape(shape).astype(bool)


def edge_mask(n: int, lattice: str, ct_inv_t: np.ndarray,
              lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """Boolean (3, N, N, N) mask of material edge DoFs; ``ct_inv_t`` is
    inv(CT^T) of the lattice."""
    return _mask("pcx_edge_mask", (3, n, n, n), n, lattice, ct_inv_t, lib)


def volume_mask(n: int, lattice: str, ct_inv_t: np.ndarray,
                lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """Boolean (N, N, N) mask of material cell centres."""
    return _mask("pcx_volume_mask", (n, n, n), n, lattice, ct_inv_t, lib)


if __name__ == "__main__":
    if "--build" in sys.argv:
        print(build(verbose=True))
        sys.exit(0)
    print(f"usage: python -m pcx_torch.native --build "
          f"(library: {library_path()})")
