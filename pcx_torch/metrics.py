"""Structured metrics & logging.

A copy of ``SolveRecord`` and ``RunLogger`` from ``pcx/metrics.py`` (which
loads JAX through ``pcx.utils``), with one more field, ``omega_pnt``.

The reference logs with ANSI-colored prints and persists per-solve
``info = [iterations, total_time]`` arrays plus optional residual histories
to .bin files (paper_2/environment.py:62-69, lobpcg.py:488-491,
paper_2_test.py:358-359).  pcx writes structured JSONL records instead —
one line per solve — so sweeps are machine-analyzable, plus the same
colored console summaries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from pcx_torch.utils import GREEN, RED, RESET


@dataclasses.dataclass
class SolveRecord:
    kind: str                   # "eigen_1p" | "bandgap_k" | ...
    lattice: str
    n: int
    diel_type: str
    alpha: list
    iterations: int
    wall_s: float
    status: int
    omega: Optional[list] = None       # recomputed frequencies
    omega_pnt: Optional[list] = None   # penalized ones: the spurious gate
                                       # bounds |omega_pnt - omega| by 1e-3
    residual_tail: Optional[list] = None
    timestamp: float = 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, default=float)


class RunLogger:
    """Append-only JSONL metrics sink + colored console summaries."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log_solve(self, record: SolveRecord):
        record.timestamp = time.time()
        if self.path:
            with open(self.path, "a") as f:
                f.write(record.to_json() + "\n")
        if self.echo:
            ok = record.status in (1, 5)
            color = GREEN if ok else RED
            print(f"{color}[{record.kind}] {record.lattice} N={record.n} "
                  f"iters={record.iterations} t={record.wall_s:.2f}s "
                  f"status={record.status}{RESET}")

    @staticmethod
    def from_result(kind, cfg, alpha, result) -> SolveRecord:
        return SolveRecord(
            kind=kind, lattice=cfg.lattice or "random", n=cfg.n,
            diel_type=cfg.diel_type, alpha=list(np.asarray(alpha, float)),
            iterations=int(result.iterations), wall_s=float(result.wall_time),
            status=int(result.status),
            omega=(list(map(float, result.omega_re))
                   if result.omega_re is not None else None),
            omega_pnt=(list(map(float, result.omega))
                       if result.omega is not None else None),
        )


def load_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
