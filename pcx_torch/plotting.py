"""Band-diagram plotting and band-gap statistics.

Port of ``pcx/plotting.py`` (reference: paper_1_python/output.py:19-77).
``compute_bandgap`` and ``gap_ratio`` are numpy only; ``plot_bandgap``
imports matplotlib when it is called (the ``plot`` extra of
pyproject.toml), so the package imports where matplotlib is absent.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pcx_torch import lattices
from pcx_torch.io import load_reference_band_json

# High-symmetry point labels per Bravais family, ordered like the paths of
# ``lattices.sym_points`` (reference: plot_bandgap, output.py:40-66).
PATH_LABELS = {
    "sc": ["$\\Gamma$", "X", "M", "R", "$\\Gamma$"],
    "bcc": ["H", "$\\Gamma$", "P", "H", "N", "$\\Gamma$", "H'", "P", "N"],
    "fcc": ["X", "W", "L", "$\\Gamma$", "X", "W'", "K"],
}


def compute_bandgap(frequencies: np.ndarray, n_gap: int = 1,
                    min_edge: float = 0.02) -> np.ndarray:
    """The largest spectral gap(s) over a whole band library:
    [omega_below, omega_above], or (n_gap, 2) of them (reference:
    compute_bandgap_ratio, output.py:19-36).  Frequencies at or below
    ``min_edge`` (the acoustic region near Gamma) are left out: there a
    coarsely sampled path fakes a large gap above the zero modes."""
    f = np.sort(np.asarray(frequencies).flatten())
    f = f[f > min_edge]
    d = np.diff(f)
    if n_gap == 1:
        i = int(np.argmax(d))
        return np.array([f[i], f[i + 1]])
    inds = np.argsort(-d)[:n_gap]
    return np.stack([[f[i], f[i + 1]] for i in sorted(inds)])


def gap_ratio(omgs: np.ndarray) -> float:
    """Gap-to-midgap ratio 2 (w2 - w1) / (w2 + w1)."""
    return float(2 * (omgs[1] - omgs[0]) / (omgs[1] + omgs[0]))


def plot_bandgap(n: int, lattice: str, diel_type: str = "chiral",
                 eps_opt: int = 0, output_dir: str = "output",
                 save_path: Optional[str] = None, show: bool = False,
                 verbose: bool = True):
    """Scatter band diagram of a band library with symmetry-point ticks and
    the gap ratio in the title; returns (gap ratio, [omega_below,
    omega_above]) (reference: plot_bandgap, output.py:39-77)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    suffix = str(eps_opt) if eps_opt else ""
    path = f"{output_dir}/{diel_type}/bandgap_{lattice}{suffix}.json"
    freqs, iters = load_reference_band_json(path, lattice, n)
    freqs = np.asarray(freqs, dtype=float)
    valid = np.all(freqs > 0, axis=1)

    omgs = compute_bandgap(freqs[valid])
    ratio = gap_ratio(omgs)

    labels = PATH_LABELS[lattices.family(lattice)]
    n_k, nev = freqs.shape
    n_pt = len(labels) - 1
    gap = round(n_k / n_pt)

    fig, ax = plt.subplots(figsize=(8, 5))
    ks = np.arange(1, n_k + 1)
    for j in range(nev):
        ax.scatter(ks[valid], freqs[valid, j], s=3)
    if ratio > 0:
        ax.axhspan(omgs[0], omgs[1], alpha=0.15, color="gray")
    ax.set_xlabel("Wave Vector")
    ax.set_ylabel(r"$\omega / 2\pi$")
    ax.set_title(f"{lattice} band structure, N={n}, "
                 f"gap ratio={ratio:.6f}")
    ax.set_xticks(np.linspace(0, n_pt * gap, n_pt + 1))
    ax.set_xticklabels(labels)

    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)

    if verbose:
        it = np.asarray(iters, dtype=float)
        print(f"Average iterations = {it[valid, 0].mean():6.2f}.")
        print(f"Average runtime = {it[valid, 1].mean():6.2f} s.")
        print(f"Bandgap info from {path}.")
    return ratio, omgs
