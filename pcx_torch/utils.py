"""Small utilities: robust sqrt, dtype helpers, per-vector dots and norms.

Port of ``pcx/utils.py``.  A block of m vectors is a tensor of shape
``(m, ...)``: the vector index first, each vector contiguous.
"""

from __future__ import annotations

import torch

RED = "\033[31m"
GREEN = "\033[32m"
YELLOW = "\033[33m"
RESET = "\033[0m"

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) torch dtype."""
    return _REAL.get(dtype, dtype)


def sqrt_robust(x: float) -> float:
    """Clamp tiny negatives to 0 before sqrt
    (reference: environment.py:59, numerical_experiments.py:135-140)."""
    return 0.0 if x < 1e-10 else float(x) ** 0.5


def norms(x: torch.Tensor) -> torch.Tensor:
    """Per-vector 2-norms of a block (m, ...) -> (m,) in the real dtype."""
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)


def dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-vector inner products diag(X^H Y) -> (m,)."""
    return torch.sum(x.reshape(x.shape[0], -1).conj()
                     * y.reshape(y.shape[0], -1), dim=1)
