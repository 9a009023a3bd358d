"""The library-recovery tools of the port (``python -m pcx_torch.f64_truth``,
``record_vs_truth``, ``rescue_point``, ``preflight_queue``, ``iter_tail``)
and ``lattices.lattice_info``/``k_point`` and ``native.available`` at small
N on the CPU, against the JAX package: one complex128 solve of pcx's
``KPointSolver`` at sc_curv N=8, k_path index 3, shared by the module, is
the truth the tools' frequencies are held to.  The tools run in-process
with ``device="cpu"``, their commands with ``--cpu``; without ``--cpu`` a
command on a host without a card exits non-zero."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import lattices as jlat
from pcx.bandstructure import KPointSolver as JKPointSolver
from pcx.config import ProblemConfig as JProblemConfig
from pcx_torch import lattices, native
from pcx_torch import iter_tail as it
from pcx_torch import preflight_queue as pq
from pcx_torch import record_vs_truth as rvt
from pcx_torch import rescue_point as rp
from pcx_torch.io import BandLibrary
from pcx_torch.solvers.lobpcg import Status

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LATTICE, K = 8, "sc_curv", 3
N_K = lattices.k_path(LATTICE).shape[0]
CPU = "cpu"
OK = (Status.CONVERGED, Status.FLOOR)
# Two complex128 solves converged to a residual t agree to O(t^2) in the
# frequencies: 1e-8 at the pin's t = 1e-7, 1e-7 at the sweep's t = 1e-4
# (N=8).  A complex64 solve lies within its rounding floor, 1e-4 here.
PIN_TOL, SWEEP_TOL, C64_TOL = 1e-8, 1e-7, 1e-4


def _run(args, timeout=300):
    """``python <args>`` from the checkout with two intra-op threads."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT, env=env)


@pytest.fixture(scope="module")
def jax_omega():
    """pcx's complex128 frequencies at (sc_curv, N=8, k=3), solved as
    tools/f64_truth.py solves a pin."""
    cfg = JProblemConfig(n=N, lattice=LATTICE, nev=10)
    solver = JKPointSolver(cfg, dtype=jnp.complex128, tol=1e-7,
                           maxiter=1500)
    res = solver.solve(jlat.k_path(LATTICE)[K], seed=0, validate_result=True)
    return np.asarray(res.omega_re, float)


@pytest.fixture(scope="module")
def pin(tmp_path_factory):
    """The port's f64 pin of (sc_curv, N=8, k=3), written by its command."""
    path = str(tmp_path_factory.mktemp("pin") / "pin.json")
    r = _run(["-m", "pcx_torch.f64_truth", "--lattice", LATTICE, "--n",
              str(N), "--k", str(K), "--out", path, "--cpu"])
    assert r.returncode == 0, r.stderr[-800:]
    assert "# wrote" in r.stdout and "peak device memory" in r.stdout
    return path


def _library(path, failed_row):
    """A sc_curv N=8 band library with every row computed (made-up
    frequencies) but ``failed_row``, which is failed; returns its rows."""
    lib = BandLibrary(path, LATTICE, N, N_K, 10)
    for i in range(N_K):
        lib.record(i, 10 + i, 0.5, np.linspace(0.1, 1.0, 10) + i)
    lib.record(failed_row, -1, -1, None)
    return json.load(open(path))


@pytest.mark.parametrize("lattice", ["sc_flat1", "sc_flat2", "sc_curv",
                                     "bcc_sg", "bcc_dg", "fcc"])
def test_lattice_info_and_k_point_match_pcx(lattice):
    ct, sym = lattices.lattice_info(lattice)
    jct, jsym = jlat.lattice_info(lattice)
    np.testing.assert_array_equal(ct, jct)
    np.testing.assert_array_equal(sym, jsym)
    n_seg = sym.shape[0] - 1
    for no in range(0, n_seg * 4, 3):
        np.testing.assert_array_equal(lattices.k_point(lattice, no, gap=4),
                                      jlat.k_point(lattice, no, gap=4))


def test_native_available_is_a_bool():
    assert isinstance(native.available(), bool)


def test_f64_truth_matches_pcx_and_the_committed_schema(pin, jax_omega):
    rec = json.load(open(pin))
    np.testing.assert_allclose(rec["omega_f64"], jax_omega, rtol=0,
                               atol=PIN_TOL)
    assert rec["status"] in OK and rec["k"] == K
    np.testing.assert_allclose(rec["alpha_over_pi"],
                               jlat.k_path(LATTICE)[K] / np.pi, atol=1e-10)
    committed = json.load(open(os.path.join(
        ROOT, "data", "bcc_sg_n120_k100_f64.json")))
    assert list(rec) == list(committed)


def test_f64_truth_refuses_an_unconverged_pin(tmp_path):
    out = tmp_path / "pin.json"
    r = _run(["-m", "pcx_torch.f64_truth", "--lattice", LATTICE, "--n",
              str(N), "--k", str(K), "--maxiter", "2", "--out", str(out),
              "--cpu"])
    assert r.returncode == 1
    assert "refusing" in r.stderr and not out.exists()


def test_record_vs_truth_records_the_row(tmp_path, pin, jax_omega):
    path = str(tmp_path / "chiral" / f"bandgap_{LATTICE}.json")
    before = _library(path, K)
    out = rvt.record_vs_truth(LATTICE, K, n=N, truth=pin, tries=2,
                              output=str(tmp_path), device=CPU)
    assert out.recorded and out.deviation < 1e-3 / 4
    assert len(out.tries) == 1          # the first try is within gate / 4
    after = json.load(open(path))
    key = f"{LATTICE}_{N}"
    np.testing.assert_allclose(after[f"{key}_frequencies"][K], jax_omega,
                               rtol=0, atol=C64_TOL)
    assert after[f"{key}_iterations"][K][0] > 0
    for i in set(range(N_K)) - {K}:
        for part in ("iterations", "frequencies"):
            assert after[f"{key}_{part}"][i] == before[f"{key}_{part}"][i]


def test_record_vs_truth_refuses_above_the_gate(tmp_path, pin):
    path = str(tmp_path / "chiral" / f"bandgap_{LATTICE}.json")
    _library(path, K)
    before = open(path).read()
    r = _run(["-m", "pcx_torch.record_vs_truth", "--lattice", LATTICE,
              "--n", str(N), "--k", str(K), "--truth", pin, "--gate",
              "1e-12", "--tries", "2", "--output", str(tmp_path), "--cpu"])
    assert r.returncode == 1, r.stderr[-800:]
    assert "REFUSED" in r.stdout and r.stdout.count("# try") == 2
    assert open(path).read() == before


def test_record_vs_truth_reads_the_legacy_pin_schema(tmp_path):
    legacy = os.path.join(ROOT, "data", "bcc_sg_k37_f64.json")
    truth = rvt.load_truth(legacy, "bcc_sg", 120)
    assert (truth["lattice"], truth["n"], truth["diel"]) == (
        "bcc_sg", 120, "chiral")
    with pytest.raises(ValueError, match="pin of"):
        rvt.load_truth(legacy, "bcc_dg", 120)


@pytest.mark.parametrize("steps", [["coarse", "f64"], ["f64"],
                                   ["refine64"]])
def test_rescue_point_recovers_a_failed_row(tmp_path, jax_omega, steps):
    """Each rung (the complex64 ones in complex128 on the CPU) recovers the
    row; the first rung that does ends the ladder."""
    out = str(tmp_path)
    path = os.path.join(out, "chiral", f"bandgap_{LATTICE}.json")
    before = _library(path, K)
    r = _run(["-m", "pcx_torch.rescue_point", "--n", str(N), "--lattice",
              LATTICE, "--output", out, "--steps", *steps, "--coarse-n", "4",
              "--cpu"])
    assert r.returncode == 0, (r.stdout + r.stderr)[-1500:]
    assert f"rescue step '{steps[0]}' on indices [{K}]" in r.stdout
    assert r.stdout.count("# rescue step") == 1
    after = json.load(open(path))
    key = f"{LATTICE}_{N}"
    np.testing.assert_allclose(after[f"{key}_frequencies"][K], jax_omega,
                               rtol=0, atol=SWEEP_TOL)
    for i in set(range(N_K)) - {K}:
        assert after[f"{key}_frequencies"][i] == before[f"{key}_frequencies"][i]


def test_rescue_point_with_nothing_to_rescue(tmp_path):
    out = rp.rescue(n=N, lattice=LATTICE, output=str(tmp_path), device=CPU)
    assert out.ok and out.rungs == [] and out.indices == []
    r = _run(["-m", "pcx_torch.rescue_point", "--n", str(N), "--lattice",
              LATTICE, "--output", str(tmp_path), "--cpu"])
    assert r.returncode == 0 and "no failed rows to rescue" in r.stdout


def test_preflight_two_configs_on_the_cpu(monkeypatch):
    monkeypatch.delenv("PCX_REFERENCE", raising=False)
    configs = [("sc_curv", "pseudochiral_trivial", 0),
               ("bcc_dg", "chiral", 0)]
    out = pq.preflight(configs=configs, n=8, points=1, device=CPU)
    assert [(r.lattice, r.diel, r.eps_opt) for r in out] == configs
    assert all(r.ok and r.computed == 1 and r.bad == [] for r in out)
    assert all(r.golden is None for r in out)      # no reference here


def test_reference_candidates_match_golden_diff():
    """The port's copy of tools/golden_diff.py's name mapping, rooted at a
    given reference checkout."""
    from tools import golden_diff
    root = os.path.dirname(os.path.dirname(golden_diff.REF))
    for lattice, diel, eps_opt in pq.CONFIGS:
        for n in (100, 120):
            assert pq.reference_candidates(lattice, n, diel, eps_opt,
                                           root=root) == \
                golden_diff.reference_candidates(lattice, n, diel, eps_opt)
    assert pq.reference_candidates("bcc_sg", 120, "chiral", 0, root="") == []


def test_iter_tail_two_variants(capsys):
    recs = it.iter_tail(n=N, only=["base", "lam2e6"], device=CPU)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == recs and [r["variant"] for r in recs] == ["base",
                                                               "lam2e6"]
    keys = ["variant", "n", "lattice", "diel", "iters", "status", "val"]
    assert list(recs[0]) == keys
    assert list(recs[1]) == keys + ["max_domega_vs_base"]
    for rec in recs:
        assert all(s in OK for s in rec["status"])
        assert all(v <= 1e-3 for v in rec["val"])
    assert recs[1]["max_domega_vs_base"] <= 1e-4


def test_iter_tail_variants_are_the_jax_tools_without_w_cap():
    """The variants are the JAX tool's, whole: w_cap="auto" of stack_p3
    and stack_lam2e6 included (the name is older than the port's w_cap)."""
    from tools import iter_tail as jit_tool
    assert it.VARIANTS == jit_tool.VARIANTS
    assert dict(it.VARIANTS)["stack_lam2e6"]["w_cap"] == "auto"


@pytest.mark.parametrize("args", [
    ["-m", "pcx_torch.f64_truth", "--k", "3", "--n", "8"],
    ["-m", "pcx_torch.record_vs_truth", "--lattice", "sc_curv", "--k", "3"],
    ["-m", "pcx_torch.rescue_point", "--n", "8"],
    ["-m", "pcx_torch.preflight_queue", "--n", "8"],
    ["-m", "pcx_torch.iter_tail", "--n", "8"]])
def test_tools_refuse_to_fall_back_to_the_cpu(args):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    r = _run(args)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr
