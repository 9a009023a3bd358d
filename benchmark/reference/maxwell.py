"""The plain reference: the penalized Maxwell operator of one k-point in
complex128, and the judge of a block of Ritz vectors.

The operator (paper_2/pcfft.py:130-181, discretization.py:301-453), on a
Fourier-space block x of shape (m, 3, N, N, N):

    H x = D x (M (D^H x)) + pnt conj(D) (D . x) + shift x

where D is the curl symbol D[c] = sum_j CT[c, j] d1[axis j]
+ i alpha_c d0[axis c], with d1 = N (e^{2 pi i f / N} - 1) the staggered
first difference at step 1/N and d0 = (1 + e^{2 pi i f / N}) / 2 the
staggered average; ``D x`` is the cross product D x x, ``D^H x`` the cross
product with -conj(D); M is eps^{-1} in physical space, which the block
reaches by ``fftn`` and leaves by ``ifftn``.  Every piece is built here
from the configuration: nothing is taken from the program.

``judge`` takes the program's answer at one k-point, its Ritz block and
its reported frequencies, and works out from the block alone, in
complex128: the Rayleigh-Ritz pencil of H on the block's span, the leading
``nev`` Ritz pairs, their Rayleigh quotients against the unpenalized
operator and their residuals.  It returns the three numbers that
``correct`` compares (``Readings``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark import lattices
from benchmark.reference import geometry

CHIRAL_EPS = {"sc_flat1": 13.0, "sc_flat2": 13.0, "sc_curv": 13.0,
              "bcc_sg": 16.0, "bcc_dg": 16.0, "fcc": 13.0}
# eps^{-1} tensors of the pseudochiral media as (d11, d22, d33, d12, d13,
# d23), before division by the lattice's chiral constant
# (paper_2/environment.py:52-55)
PSEUDOCHIRAL_EPS = [
    np.array([(1 + 0.875 ** 2) ** 0.5, (1 + 0.875 ** 2) ** 0.5, 1.0,
              -1j * 0.875, 0.0, 0.0]),
    np.array([(1 + 0.875 ** 2) ** 0.5, 1.0, (1 + 0.875 ** 2) ** 0.5,
              0.0, 1j * 0.875, 0.0]),
    np.array([1.0346, 0.5059, 0.2595,
              -0.0163 - 0.2319j, 0.027 + 0.0827j, -0.2743 - 0.0076j]),
    np.array([3.0, 3.0, 3.0,
              np.sqrt(3) + 1j, 1j, np.sqrt(2) * (1 + 1j)]) / 5.0,
]
# (row component, column component, axis of the forward average, axis of
# the transposed average) of each off-diagonal pair of the cross-DoF
# medium, axes of the (i, j, k) grid (paper_2/discretization.py:403-453)
CROSS_PAIRS = ((0, 1, 2, 1), (0, 2, 2, 0), (1, 2, 1, 0))


def _avg(x: torch.Tensor, axis: int, forward: bool) -> torch.Tensor:
    """The staggered average along a grid axis (of the last three):
    forward (x[r] + x[r + 1]) / 2, transposed (x[r] + x[r - 1]) / 2."""
    dim = x.dim() - 3 + axis
    return 0.5 * (x + torch.roll(x, -1 if forward else 1, dims=dim))


class Dielectric:
    """eps^{-1} of a configuration in physical space, complex128."""

    def __init__(self, config: dict, device, cache: bool = True):
        n, lattice = config["n"], config["lattice"]
        edge = geometry.edge_mask(n, lattice, cache=cache)
        kind = config["diel_type"]
        self.kind = kind
        if kind == "chiral":
            eps = float(config["eps_opt"]) or CHIRAL_EPS[lattice]
            self.scale = torch.as_tensor(np.where(edge, 1.0 / eps, 1.0),
                                         device=device)
        elif kind == "pseudochiral_crossdof":
            loc = PSEUDOCHIRAL_EPS[config["eps_opt"]] / CHIRAL_EPS[lattice]
            self.diag = torch.as_tensor(np.stack(
                [np.where(edge[c], loc[c].real, 1.0) for c in range(3)]),
                device=device)
            self.masks = torch.as_tensor(edge.astype(np.float64),
                                         device=device)
            self.off = [complex(e) for e in loc[3:6]]
        else:
            raise ValueError(f"the reference has no dielectric {kind!r}")

    def to(self, dtype: torch.dtype) -> "Dielectric":
        """A copy whose arrays are in the real ``dtype``."""
        out = object.__new__(Dielectric)
        out.__dict__.update({k: (v.to(dtype) if isinstance(v, torch.Tensor)
                                 else v) for k, v in self.__dict__.items()})
        return out

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "chiral":
            return y * self.scale
        out = y * self.diag
        r = self.masks
        for (a, b, fwd, tr), e in zip(CROSS_PAIRS, self.off):
            if e == 0:
                continue

            def t(v):        # T_ab
                return _avg(_avg(v, fwd, True), tr, False)

            def t_h(v):      # T_ab^T
                return _avg(_avg(v, fwd, False), tr, True)

            ya, yb = y[..., a, :, :, :], y[..., b, :, :, :]
            # M_ab = e (R_a T + T R_b) / 2 and its conjugate transpose
            out[..., a, :, :, :] += 0.5 * e * (r[a] * t(yb) + t(r[b] * yb))
            out[..., b, :, :, :] += 0.5 * np.conj(e) * (
                t_h(r[a] * ya) + r[b] * t_h(ya))
        return out


def curl_symbol(config: dict, alpha, device) -> torch.Tensor:
    """D, complex128 (3, N, N, N), at the dimensionless wave vector alpha
    (the lattice constant is 1)."""
    n = config["n"]
    z = np.exp(2j * np.pi * np.arange(n) / n)
    d1 = torch.as_tensor(n * (z - 1.0), device=device)
    d0 = torch.as_tensor((1.0 + z) / 2.0, device=device)
    ct = lattices.ct_matrix(config["lattice"])
    alpha = np.asarray(alpha, float)

    def along(v, axis):
        shape = [1, 1, 1]
        shape[axis] = n
        return v.reshape(shape)

    rows = []
    for c in range(3):
        s = sum(float(ct[c, j]) * along(d1, j) for j in range(3))
        rows.append((s + 1j * float(alpha[c]) * along(d0, c)).expand(n, n, n))
    return torch.stack(rows)


def _cross(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d x x on the component axis (the fourth from the end)."""
    d0, d1, d2 = d[0], d[1], d[2]
    x0, x1, x2 = x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]
    return torch.stack((d1 * x2 - d2 * x1, d2 * x0 - d0 * x2,
                        d0 * x1 - d1 * x0), dim=-4)


class Operator:
    """H and its unpenalized part A at one k-point, complex128."""

    def __init__(self, config: dict, diel: Dielectric, alpha, device):
        (shift, _), pnt = lattices.set_relaxation(alpha)
        self.shift, self.pnt = float(shift), float(pnt)
        self.d = curl_symbol(config, alpha, device)
        self.diel = diel

    def a(self, x: torch.Tensor) -> torch.Tensor:
        y = _cross(-self.d.conj(), x)
        y = torch.fft.ifftn(self.diel(torch.fft.fftn(y, dim=(-3, -2, -1))),
                            dim=(-3, -2, -1))
        return _cross(self.d, y)

    def h(self, x: torch.Tensor) -> torch.Tensor:
        div = (self.d * x).sum(dim=-4, keepdim=True)
        return self.a(x) + self.pnt * self.d.conj() * div + self.shift * x


class Readings(NamedTuple):
    """What ``correct`` compares at one k-point.

    omega_gap:    the widest gap between a frequency the program reported
                  (penalized ``omega`` and recomputed ``omega_re``) and the
                  reference's of the same band from the program's block;
    spurious_gap: the widest gap between the reference's penalized and
                  unpenalized frequency of a band (a divergence component);
    freq_bound:   the widest frequency-error bound res / (8 pi^2 omega)
                  of a band, its residual against the reference operator.
    """
    omega_gap: float
    spurious_gap: float
    freq_bound: float


def frequency(lam) -> np.ndarray:
    return np.sqrt(np.maximum(np.asarray(lam, float), 0.0)) / (2 * np.pi)


def _gram(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """<a_i, b_j> over rows, as a complex128 numpy array."""
    return (a.conj() @ b.transpose(0, 1)).cpu().numpy()


def ritz(op: Operator, x: torch.Tensor):
    """Rayleigh-Ritz of H on the rows of x: (theta (m,), coefficients
    (m, m)) with x's Gram matrix the metric; raises LinAlgError when the
    block is rank deficient."""
    m = x.shape[0]
    xf = x.reshape(m, -1)
    t = _gram(xf, op.h(x).reshape(m, -1))
    g = _gram(xf, xf)
    t, g = (t + t.conj().T) / 2, (g + g.conj().T) / 2
    low = np.linalg.cholesky(g)
    inv = np.linalg.inv(low)
    theta, v = np.linalg.eigh(inv @ t @ inv.conj().T)
    return theta, inv.conj().T @ v


def quotients(op: Operator, y: torch.Tensor, theta: np.ndarray):
    """(Rayleigh quotients against A, residual norms of A y - (theta -
    shift) y, each over |y|) of the rows of y."""
    nev = y.shape[0]
    yf = y.reshape(nev, -1)
    ay = op.a(y).reshape(nev, -1)
    den = (yf.conj() * yf).real.sum(dim=1)
    lam_re = ((yf.conj() * ay).real.sum(dim=1) / den).cpu().numpy()
    lam = torch.as_tensor(theta - op.shift, device=y.device)
    res = (torch.linalg.vector_norm(ay - lam[:, None] * yf, dim=1)
           / den.sqrt()).cpu().numpy()
    return lam_re, res


def judge(config: dict, op: Operator, x: torch.Tensor, omega, omega_re
          ) -> Readings:
    """The readings of a program's answer at one k-point: its Ritz block
    ``x`` (m, 3, N, N, N) and its frequencies ``omega``, ``omega_re``
    (nev,).  A block the reference cannot project on reads inf."""
    nev = config["nev"]
    x = x.to(torch.complex128)
    try:
        theta, c = ritz(op, x)
    except np.linalg.LinAlgError:
        return Readings(np.inf, np.inf, np.inf)
    coef = torch.as_tensor(c[:, :nev].T.copy(), device=x.device)
    y = (coef @ x.reshape(x.shape[0], -1)).reshape((nev,) + x.shape[1:])
    lam_re, res = quotients(op, y, theta[:nev])
    lam_pnt = theta[:nev] - (op.shift if op.shift > 0 else 0.0)
    w_pnt, w_re = frequency(lam_pnt), frequency(lam_re)
    reported = [np.asarray(w if w is not None else [], float).reshape(-1)
                for w in (omega, omega_re)]
    if any(w.size < nev for w in reported):   # an answer that never came
        reported = [np.full(nev, np.inf)] * 2
    gaps = [np.abs(reported[0][:nev] - w_pnt),
            np.abs(reported[1][:nev] - w_re)]
    bound = res * config.get("scal", 1.0) ** 2 / (
        8 * np.pi ** 2 * np.maximum(w_re, 0.05))
    vals = (np.max(gaps), np.max(np.abs(w_pnt - w_re)), np.max(bound))
    return Readings(*(float(v) if np.isfinite(v) else np.inf for v in vals))
