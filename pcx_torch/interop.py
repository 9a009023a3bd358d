"""State carried across from the JAX package, given as numpy arrays.

Turns the arrays a ``pcx`` solver holds into the port's objects, so that
both packages can be run on identical state (tests), independently of
geometry parity:

* a dielectric, from the ``name``, ``params`` and ``meta`` of a pcx
  ``DielectricOp`` (``dielectric_from``), or only the chiral ε⁻¹ scale
  (``dielectric``);
* the 1-D symbol parts d1, d0 and ct (``KPointSolver._f64`` in pcx, there
  as (re, im) float64 pairs);
* the DFT matrices (``dft.dft_mats``);
* a start block x0.

``KPointSolver.from_arrays`` builds a solver on such state.  This module
imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from pcx_torch.operators.dft import DFTMats
from pcx_torch.operators.dielectric import (CrossDofOp, DielectricOp,
                                            HermBlockOp, ScaleOp,
                                            identity_op)
from pcx_torch.operators.symbols import SymbolParts


def _complex(a) -> np.ndarray:
    """A complex array, or a (re, im) pair of real ones, as complex128."""
    if isinstance(a, (tuple, list)):
        return np.asarray(a[0], np.float64) + 1j * np.asarray(a[1], np.float64)
    return np.asarray(a, np.complex128)


def dielectric(scale, device) -> DielectricOp:
    """Chiral dielectric from its (3, N, N, N) real ε⁻¹ scale."""
    return dielectric_from("chiral", (scale,), (), device)


def dielectric_from(name: str, params, meta, device) -> DielectricOp:
    """The port's operator for a pcx ``DielectricOp``, by its ``name``, from
    its ``params`` as numpy arrays and its ``meta``:

    * ``chiral`` / ``scalar_field``: ``params = (scale,)``;
    * ``pseudochiral_trivial``: ``params = (diag, sdiag)``, sdiag complex
      or a (re, im) pair;
    * ``pseudochiral_crossdof``: ``params = (diag, masks)`` and
      ``meta = (("sten", ...), ("eps", (e3, e4, e5)))``;
    * ``identity``: no params.
    """
    real = lambda a: np.asarray(a, np.float64)
    if name == "identity":
        return identity_op()
    if name in ("chiral", "scalar_field"):
        return ScaleOp(real(params[0]), device, name=name)
    if name == "pseudochiral_trivial":
        return HermBlockOp(real(params[0]), _complex(params[1]), device)
    if name == "pseudochiral_crossdof":
        meta = dict(meta)
        return CrossDofOp(real(params[0]), real(params[1]), meta["sten"],
                          meta["eps"], device)
    raise KeyError(f"no port operator for dielectric {name!r}")


def symbol_parts(d1, d0, ct, device) -> SymbolParts:
    """1-D symbol parts from complex (N,) arrays or (re, im) pairs."""
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    return SymbolParts(as_t(_complex(d1), torch.complex128),
                       as_t(_complex(d0), torch.complex128),
                       as_t(np.asarray(ct, np.float64), torch.float64))


def dft(fwd, inv, dtype: torch.dtype, device) -> DFTMats:
    """DFT matrices from complex arrays or (re, im) pairs."""
    return DFTMats(*(torch.tensor(_complex(a), device=device).to(dtype)
                     for a in (fwd, inv)))


def block(x0, dtype: torch.dtype, device) -> torch.Tensor:
    """A start block (m, 3, N, N, N) from a complex array or a (re, im)
    pair."""
    return torch.tensor(_complex(x0), device=device).to(dtype)
