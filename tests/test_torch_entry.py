"""The port's entry points against the JAX package's: ``python -m
pcx_torch`` (tests/test_cli.py) with a sweep held against pcx's,
``pcx_torch.plotting`` against ``pcx.plotting``, ``pcx_torch.supervisor``
through every fake-clock scenario of tests/test_supervisor.py, and the
runner ``python -m pcx_torch.run_sweep``.  The commands run with
``--cpu`` / ``--device cpu``: on a host without a card they refuse to run
otherwise."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_supervisor as pcx_scenarios
from pcx import bandstructure as jbs
from pcx import plotting as jplot
from pcx_torch import plotting
from pcx_torch import supervisor
from pcx_torch.io import BandLibrary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_CARD = not torch.cuda.is_available()


def _run(args, timeout=300, cwd=ROOT, env=None):
    """``python <args>`` with the repo on the path and two intra-op threads
    (every parallel test worker may start one)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **(env or {}))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=cwd, env=env)


def test_cli_eigen1p():
    r = _run(["-m", "pcx_torch", "eigen1p", "--n", "8", "--lattice",
              "sc_curv", "--alpha", "1,0,0", "--nev", "4", "--cpu"])
    assert r.returncode == 0, r.stderr[-500:]
    assert "omega" in r.stdout and "status = 1" in r.stdout


def test_cli_bandgap_and_check_match_pcx(tmp_path):
    """``bandgap --cpu`` at N=8 over indices 0 and 1 writes the rows that
    pcx.bandstructure.bandgap computes, to 1e-6 in omega; ``check`` then
    lists the uncomputed rows."""
    out = str(tmp_path / "out")
    r = _run(["-m", "pcx_torch", "bandgap", "--n", "8", "--lattice",
              "sc_flat1", "--nev", "4", "--cpu", "--output", out,
              "--indices", "0,1"])
    assert r.returncode == 0, r.stderr[-500:]
    r2 = _run(["-m", "pcx_torch", "check", "--n", "8", "--lattice",
               "sc_flat1", "--cpu", "--output", out])
    assert r2.returncode == 0
    assert "uncomputed" in r2.stdout
    ref_dir = str(tmp_path / "ref")
    assert jbs.bandgap(8, "sc_flat1", nev=4, output_dir=ref_dir,
                       indices=[0, 1], verbose=False) == []
    key = "sc_flat1_8_frequencies"
    rows = [json.load(open(f"{d}/chiral/bandgap_sc_flat1.json"))[key][:2]
            for d in (out, ref_dir)]
    np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-6)


def test_cli_devices():
    r = _run(["-m", "pcx_torch", "devices"])
    assert r.returncode == 0
    assert ("cuda:0" in r.stdout) if not NO_CARD else ("cpu" in r.stdout)


@pytest.mark.skipif(not NO_CARD, reason="checks the refusal without a card")
@pytest.mark.parametrize("args", [
    ["-m", "pcx_torch", "eigen1p", "--n", "8"],
    ["-m", "pcx_torch", "check", "--n", "8", "--device", "cuda"],
    ["-m", "pcx_torch.run_sweep", "--n", "8"]])
def test_entry_points_refuse_to_fall_back_to_the_cpu(args):
    """Without a card and without --cpu / --device cpu the commands exit
    non-zero with a message, and compute nothing on the CPU."""
    r = _run(args)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "Gap" not in r.stdout and "omega" not in r.stdout


def test_plot_bandgap_matches_pcx(tmp_path):
    """``plot_bandgap`` writes a png of a committed library with the gap
    ratio of pcx.plotting; the CLI's ``plot`` prints it."""
    kw = dict(n=120, lattice="sc_curv", output_dir=os.path.join(
        ROOT, "output_c64"), verbose=False)
    png = tmp_path / "port.png"
    ratio, omgs = plotting.plot_bandgap(save_path=str(png), **kw)
    ref, ref_omgs = jplot.plot_bandgap(save_path=str(tmp_path / "jax.png"),
                                       **kw)
    assert png.stat().st_size > 10000
    assert ratio == ref and np.array_equal(omgs, ref_omgs)
    freqs = np.array(json.load(open(os.path.join(
        ROOT, "output_c64", "chiral", "bandgap_sc_curv.json")))[
            "sc_curv_120_frequencies"])
    assert plotting.gap_ratio(plotting.compute_bandgap(freqs, n_gap=2)[0]) \
        == jplot.gap_ratio(jplot.compute_bandgap(freqs, n_gap=2)[0])
    out = tmp_path / "cli.png"
    r = _run(["-m", "pcx_torch", "plot", "--n", "120", "--lattice",
              "sc_curv", "--cpu", "--output", kw["output_dir"], "--out",
              str(out)])
    assert r.returncode == 0, r.stderr[-500:]
    assert f"gap ratio {ref:.6f}" in r.stdout and out.exists()


SCENARIOS = sorted(
    name for name in dir(pcx_scenarios)
    if name.startswith("test_") and name not in (
        "test_library_status_roundtrip", "test_run_sweep_tool_uses_supervisor"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_supervisor_passes_pcx_scenario(scenario, monkeypatch):
    """Each fake-clock scenario of tests/test_supervisor.py, run against
    the port's ``supervise``."""
    assert len(SCENARIOS) == 9
    monkeypatch.setattr(pcx_scenarios, "supervise", supervisor.supervise)
    getattr(pcx_scenarios, scenario)()


def test_port_library_status_roundtrip(tmp_path):
    lib = {"sc_curv_16_iterations": [[5, 1.0], [0, 0], [-1, -1], [3, 0.5]],
           "sc_curv_16_frequencies": [[0.1] * 10] * 4}
    p = tmp_path / "bandgap_sc_curv.json"
    p.write_text(json.dumps(lib))
    assert supervisor.library_status(str(p), "sc_curv", 16) == ([1], [2])
    assert supervisor.library_status(str(tmp_path / "nope.json"), "sc_curv",
                                     16) == (None, None)


def test_run_sweep_completes_a_sweep_under_the_supervisor(tmp_path):
    """``python -m pcx_torch.run_sweep --device cpu`` routes through
    ``pcx_torch.supervisor``: it resumes a library with two pending rows
    (N=8, gap 1), computes them with the light refine in one round, leaves
    the other rows as they were, and the worker touches the heartbeat."""
    src = open(os.path.join(ROOT, "pcx_torch", "run_sweep.py")).read()
    assert "from pcx_torch.supervisor import" in src and "supervise(" in src
    path = tmp_path / "out" / "chiral" / "bandgap_sc_flat1.json"
    lib = BandLibrary(str(path), "sc_flat1", 8, 4, 10)
    for i in (2, 3):
        lib.record(i, 7, 0.5, np.arange(10) * 0.1)
    before = json.loads(path.read_text())
    r = _run(["-m", "pcx_torch.run_sweep", "--n", "8", "--lattice",
              "sc_flat1", "--gap", "1", "--device", "cpu", "--output",
              str(tmp_path / "out"), "--max-rounds", "1"],
             env={"TMPDIR": str(tmp_path)})
    assert r.returncode == 0, r.stdout[-500:] + r.stderr[-500:]
    assert "# COMPLETE" in r.stdout
    after = json.loads(path.read_text())
    its = after["sc_flat1_8_iterations"]
    assert all(it[0] > 0 for it in its[:2]) and its[2:] == before[
        "sc_flat1_8_iterations"][2:]
    assert (tmp_path / "pcx_hb_sc_flat18_chiral.hb").exists()


def test_run_sweep_refuses_k_batch():
    """--k-batch goes to bandgap(k_batch=) since the port has solve_batch;
    a group size below 1 is refused before any worker starts."""
    r = _run(["-m", "pcx_torch.run_sweep", "--k-batch", "0", "--device",
              "cpu"])
    assert r.returncode != 0 and "--k-batch" in r.stderr
