"""Small utilities: robust sqrt, dtype helpers, per-vector dots and norms,
the sum over a process group, device-synchronized timing, device memory
and convergence rates.

Port of ``pcx/utils.py``.  A block of m vectors is a tensor of shape
``(m, ...)``: the vector index first, each vector contiguous.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

RED = "\033[31m"
GREEN = "\033[32m"
YELLOW = "\033[33m"
BLUE = "\033[34m"
MAGENTA = "\033[35m"
CYAN = "\033[36m"
WHITE = "\033[37m"
RESET = "\033[0m"

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) torch dtype."""
    return _REAL.get(dtype, dtype)


def scale_cols(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Each vector of x scaled by its entry of s: the shape of s is that of
    x's leading axes ((m,) for a block, (L, m) for lanes)."""
    return x * s.reshape(s.shape + (1,) * (x.dim() - s.dim())).to(
        real_dtype(x.dtype))


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def sqrt_robust(x: float) -> float:
    """Clamp tiny negatives to 0 before sqrt
    (reference: environment.py:59, numerical_experiments.py:135-140)."""
    return 0.0 if x < 1e-10 else float(x) ** 0.5


def as_blockvec(x: torch.Tensor) -> torch.Tensor:
    """Flatten a block (m, ...) to (m, D)."""
    return x.reshape(x.shape[0], -1)


def norm(x) -> torch.Tensor:
    """Frobenius norm of all entries (reference: environment.py:117-129)."""
    return torch.linalg.vector_norm(torch.as_tensor(x))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of the process group ``group`` (JAX's
    ``psum`` over a mesh axis); ``t`` itself when ``group`` is None.  The
    sum is written into ``t`` when it is contiguous, and complex tensors
    travel as their real view."""
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t,
                    group=group)
    return t


def norms(x: torch.Tensor, reduce_axis=None) -> torch.Tensor:
    """Per-vector 2-norms of a block (m, ...) -> (m,) in the real dtype.
    ``reduce_axis``: the process group over which the vector dimension is
    sharded; the sums of squares are all-reduced over it before the root
    (pcx ``norms(axis_name=)``)."""
    if reduce_axis is None:
        return torch.linalg.vector_norm(as_blockvec(x), dim=1)
    v = as_blockvec(x)
    sq = torch.sum((v.conj() * v).real if v.is_complex() else v * v, dim=1)
    return torch.sqrt(all_reduce_sum(sq, reduce_axis))


def dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-vector inner products diag(X^H Y) -> (m,)."""
    return torch.sum(as_blockvec(x).conj() * as_blockvec(y), dim=1)


def block_until_ready(tree):
    """Wait until the card has computed every CUDA tensor in ``tree`` (a
    tensor, or lists, tuples and dicts of them) and return ``tree``: the
    port's ``jax.block_until_ready``."""
    devices = set()

    def walk(a):
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                devices.add(a.device)
        elif isinstance(a, dict):
            for v in a.values():
                walk(v)
        elif isinstance(a, (list, tuple)):
            for v in a:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def timing(process_name=None, runtime_dict=None, print_time=False):
    """Device-synchronized wall timing (reference: environment.py:84-111):
    the card is synchronized before the clock is read at both ends.  The
    yielded dict receives ``elapsed``; with ``runtime_dict`` the seconds
    add up under ``process_name``."""
    _synchronize()
    t_h = time.time()
    box = {}
    yield box
    _synchronize()
    elapsed = time.time() - t_h
    box["elapsed"] = elapsed
    if runtime_dict is not None and process_name is not None:
        runtime_dict[process_name] = (runtime_dict.get(process_name, 0.0)
                                      + elapsed)
    if print_time and process_name is not None:
        print(f"Runtime of {process_name} is {elapsed:<6.3f} s.")


def device_memory_mib() -> float:
    """Peak device memory allocated by torch on the current card, in MiB
    (``torch.cuda.max_memory_allocated``); NaN without a card (reference
    prints the cupy pool bytes, lobpcg.py:471-472)."""
    if not torch.cuda.is_available():
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2 ** 20


def convergence_rate(residuals, verbose: bool = True):
    """Average residual dampening rates by log-linear regression, over the
    whole history and each half (reference: numerical_experiments.py:
    189-202)."""
    residuals = np.asarray(residuals)

    def rated(x):
        return np.polyfit(np.arange(len(x)), x, 1)[0]

    m0 = np.exp(rated(np.log(residuals)))
    n_half = len(residuals) // 2
    m1 = np.exp(rated(np.log(residuals[:n_half])))
    m2 = np.exp(rated(np.log(residuals[n_half:])))
    if verbose:
        print(f"\nGlobal average convergence rate: {m0:<6.3f}.")
        print(f"First half average convergence rate: {m1:<6.3f}.")
        print(f"Second half average convergence rate: {m2:<6.3f}.")
    return m0, m1, m2
