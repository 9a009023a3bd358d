"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together, with ``-I csrc`` for the shared headers
``csrc/*.cuh``) and linked into ONE shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers: a build takes seconds, not
minutes).  The build runs at first use, into ``pcx_torch/_build/``
(git-ignored), under a file name keyed by a hash of the sources, the headers
and the flags, so an edited source or header rebuilds and an unchanged tree
loads.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module of the port
on a host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: name -> (argtypes, restype).  Pointers and the stream are
# c_void_p: left undeclared, ctypes would pass them as 32-bit ints.
SIGNATURES = {
    "pcx_resid_precond": ([_P] * 8 + [_I, _I, _LL, _P], _I),
    "pcx_resid_precond_blocks": ([_LL], _I),
    "pcx_axis_dft": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "pcx_axis_dft_encode_us": ([_P] + [_I] * 5, ctypes.c_double),
    "pcx_gram9": ([_P] * 8 + [_I, _I, _LL, _I, _P], _I),
    "pcx_gram9_chunks": ([_LL, _I], _LL),
    "pcx_block_combine": ([_P, _P, _P], _I),
    "pcx_op_blocks": ([_P, _P, ctypes.c_float, _P], _I),
    "pcx_gram_chunks": ([_P, _P, _P], _I),
}


def sources(csrc: str = CSRC) -> list:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def headers(csrc: str = CSRC) -> list:
    return sorted(glob.glob(os.path.join(csrc, "*.cuh")))


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of pcx_torch are "
                       "built from source and need the CUDA toolkit")


def library_path(csrc: str = CSRC) -> str:
    """The library's path, keyed by the flags and every source and header
    under ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc) + headers(csrc):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libpcx_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> list:
    """Run the commands concurrently; (command, returncode, output) each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        results.append((cmd, proc.returncode, out))
    return results


def build() -> str:
    """Compile the library unless a build of the same sources exists;
    returns its path.  Raises with the compiler's output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
                for src in sources()]
        runs = _run_all([nvcc(), *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj,
                         src]
                        for src, obj in zip(sources(), objs))
        lib = os.path.join(tmp, "lib.so")
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc(), *ARCH, "-shared", "-o", lib, *objs]])
        for cmd, rc, out in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{out}")
        with open(os.path.splitext(path)[0] + ".log", "w") as f:
            f.write("".join(out for _, _, out in runs))
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point's
    signature declared."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
