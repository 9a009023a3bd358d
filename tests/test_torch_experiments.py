"""The experiments of the port (``pcx_torch.experiments``) at small N on the
CPU, after tests/test_experiments.py: the experiments whose result does not
depend on the random start against the JAX package on the same inputs,
the others under the JAX tests' own property bounds, and every name of
``python -m pcx_torch.experiments`` with ``--cpu``.  No test reads data
outside the repository: the band-library statistics run on staged copies
of the committed output_c64 sc_curv libraries."""

import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pcx.experiments import ablations as jabl
from pcx.experiments import precision as jprec
from pcx.experiments import structure as jstruct
from pcx_torch.experiments import ablations, precision, runtime, structure
from pcx_torch.experiments.__main__ import NAMES, main

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
ALPHA = np.array([np.pi, np.pi, np.pi])
CPU = "cpu"
DIELS = ("chiral", "pseudochiral_trivial", "pseudochiral_crossdof")
# Both packages validate by a complex128 Rayleigh-Ritz refine of a
# subspace converged to the residual tolerance t; the frequencies of two
# such subspaces differ by O(t^2): 1e-7 covers t = 1e-3 at N=8.
FREQ_TOL = 1e-7


def test_tol_cmp_matches_pcx():
    out = ablations.tol_cmp(N, "sc_curv", [1e-3, 1e-5], alpha=ALPHA, nev=4,
                            verbose=False, device=CPU)
    want = jabl.tol_cmp(N, "sc_curv", [1e-3, 1e-5], alpha=ALPHA, nev=4,
                        verbose=False)
    np.testing.assert_allclose(out["omega_re"], want["omega_re"], rtol=0,
                               atol=FREQ_TOL)
    # tests/test_experiments.py: a tighter tolerance changes no frequency
    # beyond the loose one, and costs no fewer iterations
    np.testing.assert_allclose(out["omega_re"][0], out["omega_re"][1],
                               atol=2e-3)
    assert out["iters"][1][0] >= out["iters"][0][0]


def test_global_precision_cmp_matches_pcx():
    out = precision.global_precision_cmp(N, "sc_curv", alpha=ALPHA, nev=4,
                                         verbose=False, device=CPU)
    want = jprec.global_precision_cmp(N, "sc_curv", alpha=ALPHA, nev=4,
                                      verbose=False)
    assert out["omega_diff"].max() < 1e-4
    for key in ("double", "single"):
        np.testing.assert_allclose(out[key].omega_re, want[key].omega_re,
                                   rtol=0, atol=1e-4 if key == "single"
                                   else FREQ_TOL)


@pytest.mark.parametrize("lattice", ["sc_curv", "fcc", "bcc_dg"])
def test_edge_volume_census_matches_pcx(lattice):
    out = structure.edge_volume_index_cmp(10, lattice, verbose=False)
    assert out == jstruct.edge_volume_index_cmp(10, lattice, verbose=False)
    # the mismatch is a small fraction (reference: ~1% at N=100)
    assert all(m / 10 ** 3 < 0.2 for m in out)


def test_dmat_cmp_matches_pcx():
    types = ("pseudochiral_trivial", "pseudochiral_crossdof")
    rep = structure.dmat_cmp(4, types, lattice="sc_curv", verbose=False,
                             device=CPU)
    want = jstruct.dmat_cmp(4, types, lattice="sc_curv", verbose=False)
    assert rep["size"] == want["size"] and rep["nnz"] == want["nnz"]
    # the dense report: the same matrices to 1e-14 of their largest entry
    for key in ("fro", "max_nz", "min_nz", "spectral_radius"):
        assert rep[key] == pytest.approx(want[key], rel=1e-10), key
    # the constructions differ in off-diagonal coupling only, with a small
    # spectral radius, which the power method finds (tests/test_experiments)
    assert rep["nnz"] > 0
    assert rep["spectral_radius"] < 1.0
    assert abs(rep["spectral_radius_pm"] - rep["spectral_radius"]) < 0.05


@pytest.mark.parametrize("eps_opt", [0, 1, 2, 3])
def test_check_sdd_matches_pcx(eps_opt):
    got = structure.check_sdd(N, eps_opt=eps_opt, verbose=False, device=CPU)
    assert got == jstruct.check_sdd(N, eps_opt=eps_opt, verbose=False)


def _stage_libraries(out_dir, eps_opt=0):
    """Copies of the committed sc_curv libraries under the names
    bandgap_pseudo_cmp reads, bandgap_sc_curv{eps_opt}.json."""
    for t in DIELS:
        os.makedirs(os.path.join(out_dir, t), exist_ok=True)
        shutil.copy(
            os.path.join(ROOT, "output_c64", t, "bandgap_sc_curv.json"),
            os.path.join(out_dir, t, f"bandgap_sc_curv{eps_opt}.json"))
    return str(out_dir)


def test_bandgap_pseudo_cmp_matches_pcx(tmp_path):
    out = _stage_libraries(tmp_path)
    stats = structure.bandgap_pseudo_cmp(120, "sc_curv", output_dir=out,
                                         verbose=False)
    assert stats == jstruct.bandgap_pseudo_cmp(120, "sc_curv",
                                               output_dir=out, verbose=False)
    # the two discretizations agree to ~1e-2 relative (paper conclusion)
    assert stats["mean"] < 0.05
    assert stats["iter_means"]["pseudochiral_crossdof"] > 0


@pytest.mark.parametrize("name,values", [("pnt_cmp", [0.5, 1.0, 2.0]),
                                         ("rela_cmp", [0.3, 0.6, 1.0]),
                                         ("scal_cmp", [1.0, 2.0])])
def test_ablation_invariance(name, values):
    """Frequencies invariant under the penalty weight, the relaxation
    ratio and the lattice scaling, to scal_cmp's bound in
    tests/test_experiments.py (2e-4)."""
    out = getattr(ablations, name)(N, "sc_curv", values, alpha=ALPHA, nev=4,
                                   verbose=False, device=CPU)
    if name == "pnt_cmp":
        omega_re = np.stack([rep.omega_re for _, _, rep in out])
        assert all(it > 0 for _, it, _ in out)
    else:
        omega_re = out["omega_re"]
    assert omega_re.shape == (len(values), 4)
    for row in omega_re[1:]:
        np.testing.assert_allclose(row, omega_re[0], atol=2e-4)


def test_eps_cmp_frequencies_decrease_with_eps():
    out = ablations.eps_cmp(N, "sc_curv", [5.0, 13.0], alpha=ALPHA, nev=4,
                            verbose=False, device=CPU)
    assert out["omega_re"][1][0] < out["omega_re"][0][0]


def test_grid_cmp_finite():
    out = ablations.grid_cmp([6, 8], "sc_curv", alpha=ALPHA, nev=4,
                             verbose=False, device=CPU)
    assert np.isfinite(out["omega_re"]).all()


def test_library_cmp_against_scipy():
    """SciPy's LOBPCG on the same operator: its Ritz values bound the
    eigenvalues from above (Courant-Fischer), and after its 300
    unpreconditioned iterations lie within 1e-3 relative of ours."""
    ours, lib = ablations.library_cmp(6, "sc_curv", alpha=ALPHA, nev=4,
                                      verbose=False, device=CPU)
    assert ours.shape == lib.shape == (4,)
    assert np.all(lib >= ours * (1 - 1e-9))
    np.testing.assert_allclose(lib, ours, rtol=1e-3)


def test_partial_precision_cmp():
    out = precision.partial_precision_cmp(N, "sc_curv", alpha=ALPHA, nev=4,
                                          verbose=False, device=CPU)
    assert out["omega_diff"].max() < 1e-5
    assert out["mixed_iters"] > 0


def test_eigenvector_uniqueness():
    """Two random starts give the same frequencies, and the vectors of a
    non-degenerate band agree up to a unit phase.  The vectors of a
    degenerate pair may mix, which tests/test_experiments.py allows only
    where they differ by more than 0.5; at N=10, (pi,pi,pi) bands 1 and 2
    are such a pair (their frequencies agree to 1e-10), and they are
    exempt here, whatever their difference."""
    nev = 3
    out = structure.eigenvector_cmp(10, "sc_curv", alpha=ALPHA, nev=nev,
                                    verbose=False, device=CPU)
    omega = ablations.grid_cmp([10], "sc_curv", alpha=ALPHA, nev=nev + 1,
                               verbose=False, device=CPU)["omega_re"][0]
    gaps = np.abs(np.diff(omega))
    degenerate = [bool(min(gaps[max(i - 1, 0):i + 1]) < 1e-6)
                  for i in range(nev)]
    assert degenerate == [True, True, False]
    for (l_diff, x_diff, r, _), deg in zip(out, degenerate):
        assert l_diff < 1e-5
        if x_diff < 0.5 and not deg:
            assert abs(r - 1.0) < 0.1


def test_check_component_hpd():
    eig_s = structure.check_component_hpd(4, verbose=False, device=CPU)
    assert eig_s[0] > 0


def test_condition_number_of_a_scale_operator():
    """condition_number on eps^{-1} = a scale field with known extremes."""
    n = 4
    scale = torch.linspace(0.1, 1.0, 3 * n ** 3,
                           dtype=torch.float64).reshape(3, n, n, n)
    cond = structure.condition_number(lambda v: v * scale, n, verbose=False,
                                      device=CPU)
    assert cond == pytest.approx(10.0, rel=1e-3)


def test_pack_cmp_schema(tmp_path):
    out = runtime.pack_cmp(ns=[N], lattice="sc_flat1", nev=4, run_cpu=False,
                           verbose=False, device=CPU,
                           output_path=str(tmp_path / "runtime.json"))
    assert list(out) == ["sc_flat1_8"]
    rec = out["sc_flat1_8"]
    assert rec[0] > 0 and rec[2] > 0
    assert np.isnan(rec[1]) and np.isnan(rec[3])
    with open(tmp_path / "runtime.json") as f:
        assert list(json.load(f)) == ["sc_flat1_8"]


def test_cli_names_are_the_jax_names():
    with open(os.path.join(ROOT, "pcx", "experiments", "__main__.py")) as f:
        tree = ast.parse(f.read())
    jax_names = {node.comparators[0].value for node in ast.walk(tree)
                 if isinstance(node, ast.Compare)
                 and isinstance(node.left, ast.Name)
                 and node.left.id == "name"}
    assert jax_names == set(NAMES)


CLI_VALUES = {"grid_cmp": ["--values", "6,8"],
              "precision_test": ["--values", "6,8,10"],
              "largek_smooth_cmp": ["--values", "6,8,10"],
              # the stencil order k(N) = round(16.30 ln(N-10) - 58.12)
              # needs N > 10
              "largek_cmp": ["--values", "12,14"],
              # a library statistic: the staged N=120 libraries
              "bandgap_pseudo_cmp": ["--n", "120"],
              "pack_cmp": ["--values", "6"]}


@pytest.mark.parametrize("name", NAMES)
def test_cli_runs_every_experiment_on_the_cpu(name, tmp_path, capsys):
    out = _stage_libraries(tmp_path / "out")
    rc = main([name, "--cpu", "--n", "6", "--nev", "4", "--output", out]
              + CLI_VALUES.get(name, []))
    assert rc == 0
    assert capsys.readouterr().out
    if name == "pack_cmp":
        with open(os.path.join(out, "runtime_sc_curv.json")) as f:
            rec = json.load(f)["sc_curv_6"]
        assert rec[0] > 0 and rec[1] > 0 and rec[2] > 0
    if name == "compute_extreme_case":
        info = np.fromfile(os.path.join(out, "pseudochiral_trivial",
                                        "info_sc_curv.bin"))
        assert info[0] > 0


def test_cli_refuses_without_a_card_and_unknown_names(capsys):
    assert main(["no_such_experiment", "--cpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            main(["check_sdd", "--n", "4"])
        assert e.value.code not in (0, None)
