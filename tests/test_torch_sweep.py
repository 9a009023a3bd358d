"""The port's band sweep ``pcx_torch.bandstructure.bandgap`` and its band
library, against the JAX package's (tests/test_bandstructure.py): schema,
checkpoint and resume, the warm feeder of a failed row, the failure
taxonomy, the cold retry of a failed warm solve, a sweep held against the
JAX sweep, and rows of a committed library."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import bandstructure as jbs
from pcx.io import BandLibrary as JaxLibrary
from pcx_torch import bandstructure as bs
from pcx_torch.io import EMPTY, FAILED, BandLibrary, load_reference_band_json
from pcx_torch.metrics import load_jsonl

# Every parallel test worker imports this file.  The problems here are
# small, so two intra-op threads per process do; the default (one per core
# in each worker) oversubscribes the cores several times over.
torch.set_num_threads(min(torch.get_num_threads(), 2))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = dict(n=8, lattice="sc_flat1", diel_type="chiral", nev=4, gap=4,
             device="cpu")


def test_band_library_resume(tmp_path):
    path = str(tmp_path / "bandgap_test.json")
    lib = BandLibrary(path, "sc_curv", 8, n_k=5, nev=3)
    assert lib.pending_indices() == [0, 1, 2, 3, 4]
    lib.record(1, 10, 1.5, np.array([0.1, 0.2, 0.3]))
    lib.record(3, -1, -1, None)
    # Reload from disk: computed point excluded, failed point included.
    lib2 = BandLibrary(path, "sc_curv", 8, n_k=5, nev=3)
    assert lib2.pending_indices() == [0, 2, 3, 4]
    assert lib2.failed_indices() == [3]
    assert lib2.frequencies[1] == [0.1, 0.2, 0.3]
    assert lib2.iterations[3] == FAILED
    assert lib2.iterations[0] == EMPTY


def test_band_library_file_matches_pcx_byte_for_byte(tmp_path):
    """Same records, same file: the reference key schema
    (numerical_experiments.py:355-357) and the JAX package's layout."""
    files = []
    for cls, name in ((BandLibrary, "port"), (JaxLibrary, "jax")):
        path = str(tmp_path / name / "bandgap_sc_curv.json")
        lib = cls(path, "sc_curv", 100, n_k=4, nev=10)
        lib.record(0, 31, 10.79, np.arange(10) * 0.1)
        lib.record(2, -1, -1, None)
        with open(path, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]
    raw = json.loads(files[0])
    assert set(raw) == {"sc_curv_100_iterations", "sc_curv_100_frequencies"}
    freqs, iters = load_reference_band_json(
        str(tmp_path / "port" / "bandgap_sc_curv.json"), "sc_curv", 100)
    assert freqs.shape == (4, 10) and iters.shape == (4, 2)


def test_bandgap_sweep_and_resume(tmp_path):
    out = str(tmp_path / "output")
    metrics = str(tmp_path / "metrics.jsonl")
    err = bs.bandgap(indices=[0, 1, 2], output_dir=out, verbose=False,
                     metrics_path=metrics, **SWEEP)
    assert err == []
    path = f"{out}/chiral/bandgap_sc_flat1.json"
    lib = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib.pending_indices() == list(range(3, 16))
    freqs_before = [list(r) for r in lib.frequencies[:3]]
    recs = load_jsonl(metrics)
    assert [r["kind"] for r in recs] == ["bandgap_k"] * 3
    assert all(r["status"] in (1, 5) for r in recs)
    # Resume computes only the remaining points and keeps the others.
    err = bs.bandgap(output_dir=out, verbose=False, **SWEEP)
    assert err == []
    lib2 = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib2.pending_indices() == []
    assert [list(r) for r in lib2.frequencies[:3]] == freqs_before
    f = np.array(lib2.frequencies)
    assert np.isfinite(f).all() and (f >= 0).all()
    # A third call finds nothing to do.
    assert bs.bandgap(output_dir=out, verbose=False, **SWEEP) == []


def test_failed_row_retry_uses_warm_feeder(tmp_path, capsys):
    """An isolated FAILED row resumed with no warm chain first re-solves a
    computed neighbour (not recorded) and warm-starts the retry from its
    subspace."""
    out = str(tmp_path / "output")
    err = bs.bandgap(indices=[0, 1, 2], output_dir=out, verbose=False,
                     **SWEEP)
    assert err == []
    path = f"{out}/chiral/bandgap_sc_flat1.json"
    lib = BandLibrary(path, "sc_flat1", 8, 16, 4)
    row1_before = list(lib.frequencies[1])
    lib.record(0, -1, -1, None)
    assert BandLibrary(path, "sc_flat1", 8, 16, 4).failed_indices() == [0]
    err = bs.bandgap(indices=[0], output_dir=out, verbose=True, **SWEEP)
    assert err == []
    captured = capsys.readouterr().out
    assert "warm-feeder solve of computed neighbor k=1" in captured
    lib3 = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib3.failed_indices() == []
    f0 = np.array(lib3.frequencies[0])
    assert np.isfinite(f0).all() and (f0 >= 0).all()
    # The feeder solve must NOT have overwritten the neighbour's row.
    assert list(lib3.frequencies[1]) == row1_before


def test_bandgap_failure_taxonomy(tmp_path, monkeypatch):
    """Numerical failures record [-1,-1] and the sweep goes on; a CUDA
    device error aborts it, leaving the point pending."""
    calls = {"n": 0}

    def fake_solve(self, alpha, x0=None, seed=0, validate_result=True,
                   verbose=False):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("NaN residuals")   # numerical: contained
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(bs.KPointSolver, "solve", fake_solve)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bs.bandgap(output_dir=str(tmp_path), verbose=False, **SWEEP)
    lib = BandLibrary(str(tmp_path / "chiral/bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 16, 4)
    assert lib.failed_indices() == [0]       # only the numerical failure
    assert len(lib.pending_indices()) == 16   # the device-error point is not


@pytest.mark.parametrize("exc,device", [
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("gram9: CUDA launch failed with cudaError_t 700"), True),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublas"),
     True),
    (RuntimeError("cuFFT error: CUFFT_INTERNAL_ERROR"), True),
    (torch.cuda.OutOfMemoryError("Tried to allocate 2.00 GiB"), True),
    (RuntimeError("spurious eigenvalues [status=FLOOR]"), False),
    (RuntimeError("solver status NAN"), False),
    (RuntimeError("INTERNAL: XLA"), False),
])
def test_device_error_classification(exc, device):
    assert bs._is_device_error(exc) is device


def test_bandgap_warm_failure_cold_retry(tmp_path, monkeypatch):
    """A warm-started solve that fails numerically is retried once with a
    cold start before it would be recorded as [-1,-1]."""
    calls = []

    class FakeResult:
        status = 1   # CONVERGED
        iterations = 7
        wall_time = 0.5
        omega_re = np.arange(4) * 0.1
        omega = omega_re
        report = None
        x = np.ones((4, 4))

    def fake_solve(self, alpha, x0=None, seed=0, validate_result=True,
                   verbose=False):
        calls.append((x0 is not None, seed))
        if x0 is not None:   # every warm solve fails, cold ones pass
            raise RuntimeError("spurious eigenvalues")
        return FakeResult()

    monkeypatch.setattr(bs.KPointSolver, "solve", fake_solve)
    err = bs.bandgap(output_dir=str(tmp_path), verbose=False, **SWEEP)
    assert err == []
    # point 0 cold; every later point a warm attempt, then a cold retry
    # with the seed offset of pcx (seed + i + 10007)
    assert calls[0] == (False, 0)
    assert calls[1:] == [c for i in range(1, 16)
                         for c in ((True, i), (False, i + 10007))]
    lib = BandLibrary(str(tmp_path / "chiral/bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 16, 4)
    assert lib.failed_indices() == [] and lib.pending_indices() == []


def test_bandgap_takes_no_k_batch_or_mesh(tmp_path, monkeypatch):
    """The sweep now takes the JAX keywords k_batch and mesh: k_batch=2
    without a mesh solves indices [0, 1] as one solve_batch group on this
    device and the lone [2] by solve, and records all three."""
    calls = []
    batch = bs.KPointSolver.solve_batch

    def spy(self, alphas, **kw):
        calls.append((len(alphas), kw["mesh"]))
        return batch(self, alphas, **kw)

    monkeypatch.setattr(bs.KPointSolver, "solve_batch", spy)
    err = bs.bandgap(output_dir=str(tmp_path), indices=[0, 1, 2], k_batch=2,
                     mesh=None, verbose=False, **SWEEP)
    assert err == [] and calls == [(2, None)]
    lib = BandLibrary(str(tmp_path / "chiral/bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 16, 4)
    assert lib.pending_indices() == list(range(3, 16))


def test_bandgap_matches_pcx_sweep(tmp_path):
    """sc_flat1 N=8, nev=4, gap=2, indices 0-3, complex128, K3's route: the
    port's sweep against the JAX sweep with one solver_opts dict.  The cold
    start's jitter comes from different generators (torch vs jax.random),
    so the two sweeps take different paths to the same converged subspace;
    complex128 frequencies of CONVERGED solves (residual < 1e-4, eigenvalue
    error ~ residual^2) agree to 1e-9 (measured 1.2e-12)."""
    opts = {"rr_gram": "pallas", "warm_maxiter": 0, "doom_check": False}
    kw = dict(n=8, lattice="sc_flat1", nev=4, gap=2, indices=[0, 1, 2, 3],
              verbose=False)
    err_j = jbs.bandgap(output_dir=str(tmp_path / "jax"),
                        dtype=jnp.complex128, solver_opts=dict(opts),
                        solver_kw={"solver_impl": "rs",
                                   "real_boundary": True, "refine": False},
                        **kw)
    err_t = bs.bandgap(output_dir=str(tmp_path / "port"),
                       dtype=torch.complex128, solver_opts=dict(opts),
                       device="cpu", **kw)
    assert err_t == err_j == []
    libs = []
    for name in ("jax", "port"):
        with open(tmp_path / name / "chiral/bandgap_sc_flat1.json") as f:
            libs.append(json.load(f))
    assert libs[0].keys() == libs[1].keys()
    key_it, key_fq = "sc_flat1_8_iterations", "sc_flat1_8_frequencies"
    failed = [[i for i, r in enumerate(lib[key_it]) if r == FAILED]
              for lib in libs]
    assert failed[0] == failed[1] == []
    pending = [[i for i, r in enumerate(lib[key_it]) if r == EMPTY]
               for lib in libs]
    assert pending[0] == pending[1] == [4, 5, 6, 7]
    np.testing.assert_allclose(np.array(libs[1][key_fq]),
                               np.array(libs[0][key_fq]), rtol=0, atol=1e-9)


def test_bandgap_complex64_reproduces_committed_rows(tmp_path):
    """Rows 0-2 of the committed complex64 library
    examples/bandgap_sc_curv_c64_n16.json, swept by the port in complex64
    on the CPU (K1/K2/K3 plain versions, rr_gram="pallas"), the k-path
    taken from the library's own row count.  The maximum deviation is
    reported; it must sit inside the 1e-3 spurious gate."""
    src = os.path.join(ROOT, "examples", "bandgap_sc_curv_c64_n16.json")
    ref, alphas = bs._open_library(src, "sc_curv", 16, None)
    assert alphas.shape == (20, 3)   # gap 5: 20 rows over 4 path segments
    gap = alphas.shape[0] // 4
    err = bs.bandgap(n=16, lattice="sc_curv", nev=10, gap=gap,
                     indices=[0, 1, 2], output_dir=str(tmp_path),
                     dtype=torch.complex64, device="cpu", verbose=False,
                     solver_opts={"rr_gram": "pallas"})
    assert err == []
    got, _ = bs._open_library(str(tmp_path / "chiral/bandgap_sc_curv.json"),
                              "sc_curv", 16, None)
    dev = np.abs(np.array(got.frequencies[:3])
                 - np.array(ref.frequencies[:3])).max()
    print(f"max |omega_port - omega_committed| over rows 0-2: {dev:.3e}")
    assert dev < 1e-3


def test_bandgap_crossdof_reproduces_committed_rows(tmp_path):
    """Rows 1-3 of the committed complex128 library
    examples/bandgap_sc_curv_crossdof_n20.json (the JAX package's sweep of
    the cross-DoF dielectric, N=20, gap 5 from its row count), swept by the
    port in complex128 on the CPU: one cold point and two warm ones.
    CONVERGED complex128 solves agree to 1e-9 (measured 8.5e-13)."""
    src = os.path.join(ROOT, "examples", "bandgap_sc_curv_crossdof_n20.json")
    ref, alphas = bs._open_library(src, "sc_curv", 20, None)
    assert alphas.shape == (20, 3)
    err = bs.bandgap(n=20, lattice="sc_curv",
                     diel_type="pseudochiral_crossdof", nev=10,
                     gap=alphas.shape[0] // 4, indices=[1, 2, 3],
                     output_dir=str(tmp_path), dtype=torch.complex128,
                     device="cpu", verbose=False,
                     metrics_path=str(tmp_path / "metrics.jsonl"))
    assert err == []
    # each solve record carries both frequency sets of the spurious gate
    for rec in load_jsonl(str(tmp_path / "metrics.jsonl")):
        assert rec["diel_type"] == "pseudochiral_crossdof"
        assert np.abs(np.array(rec["omega_pnt"])
                      - np.array(rec["omega"])).max() < 1e-3
    got, _ = bs._open_library(
        str(tmp_path / "pseudochiral_crossdof/bandgap_sc_curv.json"),
        "sc_curv", 20, None)
    assert got.pending_indices() == [0] + list(range(4, 20))
    np.testing.assert_allclose(np.array(got.frequencies[1:4]),
                               np.array(ref.frequencies[1:4]), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("solver", ["nolock", "descent"])
def test_bandgap_passes_the_solver_variant_and_eps_opt(tmp_path, solver):
    """``solver_kw={"solver": ...}`` reaches the solver, the library goes
    to {output_dir}/{diel_type}/bandgap_{lattice}{eps_opt}.json, and the
    variant's rows agree with the softlock sweep's."""
    kw = dict(n=8, lattice="sc_flat1", diel_type="pseudochiral_trivial",
              eps_opt=1, nev=4, gap=2, indices=[1, 2], device="cpu",
              verbose=False)
    libs = []
    for name, skw in (("soft", None), (solver, {"solver": solver})):
        out = tmp_path / name
        assert bs.bandgap(output_dir=str(out), solver_kw=skw, **kw) == []
        with open(out / "pseudochiral_trivial/bandgap_sc_flat11.json") as f:
            libs.append(json.load(f))
    rows = [np.array(lib["sc_flat1_8_frequencies"][1:3]) for lib in libs]
    np.testing.assert_allclose(rows[1], rows[0], rtol=0, atol=1e-6)
    iters = [[r[0] for r in lib["sc_flat1_8_iterations"][1:3]]
             for lib in libs]
    if solver == "descent":   # no conjugate block: a slower solver
        assert sum(iters[1]) > sum(iters[0])


def test_open_library_rejects_a_row_count_off_the_path(tmp_path):
    path = str(tmp_path / "bandgap_sc_curv.json")
    BandLibrary(path, "sc_curv", 8, n_k=6, nev=10)
    with pytest.raises(ValueError, match="not a multiple of 4"):
        bs._open_library(path, "sc_curv", 8, None)
    lib, alphas = bs._open_library(path, "sc_curv", 8, 3)
    assert alphas.shape == (12, 3) and lib.n_k == 12
