"""Band-library JSON persistence, schema-compatible with the reference.

A numpy-only copy of ``pcx/io.py`` (the port never imports ``pcx``): the
same schema, sentinels and atomic ``flush``.

Schema (reference: numerical_experiments.py:355-366, 482-488):
  {
    "<flag>_<N>_iterations":  [[iters, seconds], ...]   # n_k entries
    "<flag>_<N>_frequencies": [[omega_1..omega_nev], ...]
  }
Sentinels: [0, 0] = never computed, [-1, -1] = failed (resume recomputes
exactly those; reference: numerical_experiments.py:360-404).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

EMPTY = [0, 0]
FAILED = [-1, -1]


class BandLibrary:
    """Checkpointed per-k-point results, rewritten after every k-point."""

    def __init__(self, path: str, lattice: str, n: int, n_k: int, nev: int,
                 data: Optional[dict] = None):
        """``data``: the library's contents, held in memory only: ``path``
        is neither read nor written (the ranks of a multi-card sweep other
        than its one writer)."""
        self.path = path
        self.key_it = f"{lattice}_{n}_iterations"
        self.key_fq = f"{lattice}_{n}_frequencies"
        self.n_k = n_k
        self.nev = nev
        self._write = data is None
        self._lib = {}
        self._load_or_init(data)

    @property
    def data(self) -> dict:
        return self._lib

    def _load_or_init(self, data):
        if data is not None:
            self._lib = data
        elif os.path.exists(self.path):
            with open(self.path) as f:
                self._lib = json.load(f)
        if self.key_it not in self._lib:
            self._lib[self.key_it] = [list(EMPTY) for _ in range(self.n_k)]
            self._lib[self.key_fq] = [[0.0] * self.nev for _ in range(self.n_k)]
            self.flush()

    @property
    def iterations(self) -> List[List[float]]:
        return self._lib[self.key_it]

    @property
    def frequencies(self) -> List[List[float]]:
        return self._lib[self.key_fq]

    def pending_indices(self) -> List[int]:
        """Uncomputed ([0,0]) and failed ([-1,-1]) k-point indices
        (reference resume scan: numerical_experiments.py:377-404)."""
        out = []
        for i, rec in enumerate(self.iterations):
            if list(rec) == EMPTY or list(rec) == FAILED:
                out.append(i)
        return out

    def failed_indices(self) -> List[int]:
        return [i for i, rec in enumerate(self.iterations)
                if list(rec) == FAILED]

    def record(self, index: int, iters: float, seconds: float,
               omega: Optional[np.ndarray]):
        if omega is None:
            self._lib[self.key_it][index] = list(FAILED)
            self._lib[self.key_fq][index] = [-1.0] * self.nev
        else:
            self._lib[self.key_it][index] = [float(iters), float(seconds)]
            self._lib[self.key_fq][index] = [float(v) for v in
                                             np.asarray(omega)[: self.nev]]
        self.flush()

    def flush(self):
        if not self._write:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._lib, f, indent=4)
        os.replace(tmp, self.path)


def load_reference_band_json(path: str, lattice: str, n: int):
    """Load a reference-format band library (e.g. a committed
    ``output_c64/<diel_type>/bandgap_<lattice>.json``): (frequencies,
    iterations) as numpy arrays."""
    with open(path) as f:
        lib = json.load(f)
    return (np.array(lib[f"{lattice}_{n}_frequencies"]),
            np.array(lib[f"{lattice}_{n}_iterations"]))
