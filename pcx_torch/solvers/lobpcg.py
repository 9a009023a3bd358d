"""Solver status codes and result type, with the values of
``pcx/solvers/lobpcg.py:35-52``."""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch


class Status(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    MAXITER = 2
    NAN = 3
    BLOWUP = 4
    # Residuals stopped improving at the single-precision noise floor of the
    # operator apply: the best attainable point.  The caller's
    # spurious-eigenvalue validation decides acceptability.
    FLOOR = 5


class SolveResult(NamedTuple):
    lambdas: torch.Tensor       # (m,) Ritz values (shift removed)
    x: torch.Tensor             # (m, ...) Ritz vectors
    iterations: int
    status: int                 # Status
    res_history: np.ndarray     # (maxiter,) norm of res[:nev], nan-padded
