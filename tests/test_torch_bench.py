"""The port's benchmarks (``python -m pcx_torch.bench`` and ``python -m
pcx_torch.bench_matrix``) at N=8 on the CPU, against the JAX package's
``bench.py`` and ``tools/bench_matrix.py``: the same metric, points,
statuses and iterations (within 2) from both commands in complex128; each
sweep point's frequencies within 1e-7 of a complex128 pcx solve at the same
wave vector; the sweep's gate and cold retry on constructed solves; the
matrix's rows, record keys and resume.  Without a card and without
``--cpu`` both commands exit non-zero."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import lattices as jlat
from pcx.bandstructure import KPointSolver as JKPointSolver
from pcx.config import ProblemConfig as JProblemConfig
from pcx_torch import bench, bench_matrix
from pcx_torch.bandstructure import EigenResult
from pcx_torch.config import ProblemConfig
from pcx_torch.solvers.lobpcg import Status
from pcx_torch.validate import ValidationReport

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, POINTS, LATTICE = 8, 3, "sc_curv"
# Two complex128 solves converged to tol 1e-4 agree to O(tol^2) in the
# frequencies (test_torch_tools.py SWEEP_TOL); the iteration counts of the
# two packages' solves may differ by a rounding's worth of steps.
SWEEP_TOL, ITER_SLACK = 1e-7, 2
PROTOCOLS = {"sweep": ["--n", str(N), "--sweep", str(POINTS)],
             "single": ["--n", str(N), "--sweep", "0", "--repeats", "1"]}
# '# sweep i: 0.351s, 27 iters' / '# rep 0: 0.611s, 47 iters, status X'
POINT_LINE = re.compile(r"^# (sweep|rep) (\d+): [\d.]+s, (\d+) iters"
                        r"(?:, status (\w+))?$")


def _is_ratio_of(ratio, baseline, rounded, half):
    """``ratio`` is round(baseline / v, 3) for some v that rounds to
    ``rounded`` (|v - rounded| <= ``half``), as the records write them."""
    return (baseline / (rounded + half) - 5e-4 <= ratio
            <= baseline / (rounded - half) + 5e-4)


def _run(args, timeout=300):
    """``python <args>`` from the checkout with two intra-op threads."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT, env=env)


def _parse(r) -> tuple:
    """(the JSON record of the last line, the per-point stderr lines as
    (kind, index, iterations, status or None), the retried points)."""
    assert r.returncode == 0, r.stderr[-1500:]
    record = json.loads(r.stdout.strip().splitlines()[-1])
    points, retried = [], []
    for line in r.stderr.splitlines():
        m = POINT_LINE.match(line.strip())
        if m:
            points.append((m[1], int(m[2]), int(m[3]), m[4]))
        elif "cold retry" in line:
            retried.append(line)
    return record, points, retried


@pytest.fixture(scope="module", params=sorted(PROTOCOLS))
def both(request):
    """(protocol, JAX bench.py's parse, the port's parse) of one protocol,
    each in its own process on the CPU."""
    flags = PROTOCOLS[request.param] + ["--cpu"]
    jax_run = _run(["bench.py", "--inner"] + flags)
    port_run = _run(["-m", "pcx_torch.bench"] + flags)
    return request.param, _parse(jax_run), _parse(port_run)


def test_bench_matches_the_jax_benchmark(both):
    protocol, (jrec, jpoints, jretry), (rec, points, retry) = both
    assert rec["metric"] == jrec["metric"]
    assert rec["metric"] == (f"{LATTICE}_n{N}_sweep_mean_seconds"
                             if protocol == "sweep"
                             else f"{LATTICE}_n{N}_kpoint_solve_seconds")
    assert rec["unit"] == jrec["unit"] == "s"
    assert rec.get("points") == jrec.get("points")
    assert rec["device"] == "cpu"
    assert set(rec) == set(jrec) | {"device"}
    assert _is_ratio_of(rec["vs_baseline"], 19.85, rec["value"], 5e-5)
    assert len(retry) == len(jretry)
    assert [p[:2] + p[3:] for p in points] == [p[:2] + p[3:]
                                               for p in jpoints]
    assert len(points) == (POINTS if protocol == "sweep" else 1)
    for p, jp in zip(points, jpoints):
        assert abs(p[2] - jp[2]) <= ITER_SLACK, (p, jp)


@pytest.fixture(scope="module")
def port_sweep():
    """The port's sweep protocol in-process: (exit code, record, points)."""
    return bench.run(["--cpu", "--n", str(N), "--sweep", str(POINTS),
                      "--baseline", "2.0"])


def test_sweep_points_match_pcx_solves(port_sweep):
    code, record, points = port_sweep
    assert code == 0 and record["points"] == POINTS
    mean = float(np.mean([p["wall"] for p in points]))
    assert record["value"] == round(mean, 4)
    assert record["vs_baseline"] == round(2.0 / mean, 3)
    cfg = JProblemConfig(n=N, lattice=LATTICE, nev=10)
    solver = JKPointSolver(cfg, dtype=jnp.complex128)
    path = jlat.k_path(LATTICE)
    for i, p in enumerate(points):
        assert p["i"] == i and p["index"] == bench.SWEEP_START + i
        assert p["status"] in ("CONVERGED", "FLOOR") and p["ok"]
        assert not p["cold_retry"]
        res = solver.solve(path[p["index"]], seed=0)
        np.testing.assert_allclose(p["omega"], np.asarray(res.omega_re),
                                   rtol=0, atol=SWEEP_TOL)


def test_single_protocol_in_process():
    code, record, points = bench.run(["--cpu", "--n", str(N), "--sweep",
                                      "0", "--repeats", "2"])
    assert code == 0 and len(points) == 2
    assert [p["rep"] for p in points] == [0, 1]
    value = min(p["wall"] for p in points)
    assert record["value"] == round(value, 4)
    assert record["vs_baseline"] == round(19.85 / value, 3)


class _Solver:
    """A stand-in for KPointSolver: hands out the given statuses in turn
    (an exception instance is raised instead), records each call as (warm,
    seed), and validates every solve to ``report``."""

    def __init__(self, statuses, report=None):
        self.cfg = ProblemConfig(n=N)
        self.device = torch.device("cpu")
        self.last_doom = None
        self.statuses = iter(statuses)
        self.report = report
        self.calls = []

    def solve(self, alpha, x0=None, seed=0, validate_result=True):
        self.calls.append((x0 is not None, seed))
        status = next(self.statuses)
        if isinstance(status, BaseException):
            raise status
        return _result(status)

    def validate_solution(self, alpha, res, raise_on_spurious=True):
        return self.report


def _result(status, wall=0.25):
    om = np.linspace(0.2, 0.6, 10)
    return EigenResult(omega=om, omega_re=om, lambdas=om, x=torch.zeros(2),
                       iterations=7, wall_time=wall, status=status,
                       report=None)


def _report(dev=1e-6, bound=1e-4, spurious=False):
    """A report whose frequency-error bound res scal^2 / (8 pi^2 omega) is
    ``bound`` on every band."""
    om = np.linspace(0.2, 0.6, 10)
    res = bound * 8.0 * np.pi ** 2 * om / ProblemConfig(n=N).scal ** 2
    return ValidationReport(omega_pnt=om + dev, omega_re=om, residuals=res,
                            spurious=spurious)


@pytest.mark.parametrize("status,report,ok,why", [
    (Status.CONVERGED, None, True, ""),
    (Status.FLOOR, None, True, ""),
    (Status.MAXITER, _report(bound=1e-3), True, "MAXITER accepted"),
    (Status.MAXITER, _report(bound=3e-3), False, "under-converged"),
    (Status.MAXITER, _report(dev=2e-3), False, "spurious"),
    (Status.MAXITER, _report(spurious=True), False, "spurious"),
    (Status.NAN, None, False, "status NAN")])
def test_point_ok_gate(status, report, ok, why):
    got, text = bench.point_ok(_Solver([], report), None, _result(status))
    assert got is ok and why in text


def test_rejected_warm_point_gets_one_cold_retry():
    solver = _Solver([Status.CONVERGED, Status.NAN, Status.FLOOR,
                      Status.CONVERGED])
    sw = bench.sweep_protocol(solver, LATTICE, 3, x0=torch.zeros(2))
    assert solver.calls == [(True, 0), (True, 0), (False, 1 + 10007),
                            (True, 0)]
    assert [p["cold_retry"] for p in sw.points] == [False, True, False]
    assert [p["status"] for p in sw.points] == ["CONVERGED", "FLOOR",
                                                "CONVERGED"]
    assert sw.points[1]["wall"] == 0.5 and all(p["ok"] for p in sw.points)
    assert len(sw.completed) == 2


def test_sweep_stops_at_the_third_failed_point():
    solver = _Solver([Status.NAN] * 10)
    sw = bench.sweep_protocol(solver, LATTICE, 5, x0=torch.zeros(2))
    assert len(sw.points) == 3 and not any(p["ok"] for p in sw.points)
    assert [seed for _, seed in solver.calls if seed] == [10007, 10008,
                                                          10009]
    assert sw.completed == []


def test_device_error_ends_the_chain():
    solver = _Solver([Status.CONVERGED, RuntimeError("CUDA error: lost")])
    sw = bench.sweep_protocol(solver, LATTICE, 3, x0=torch.zeros(2))
    assert len(sw.points) == 1 and sw.points[0]["ok"]
    with pytest.raises(RuntimeError, match="a code fault"):
        bench.sweep_protocol(_Solver([RuntimeError("a code fault")]),
                             LATTICE, 3)


def test_solver_opt_coercion():
    assert bench.coerce("floor_patience=3") == ("floor_patience", 3)
    assert bench.coerce("lam_tol=2e-6") == ("lam_tol", 2e-6)
    assert bench.coerce("rr_gram=pallas") == ("rr_gram", "pallas")


def _jax_tool():
    with open(os.path.join(ROOT, "tools", "bench_matrix.py")) as f:
        return ast.parse(f.read())


def test_matrix_rows_are_the_jax_tools():
    tree = _jax_tool()
    rows = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "ROWS")
    assert bench_matrix.ROWS == rows and len(rows) == 13
    assert [r[0] for r in bench_matrix.select(["north_star"])] == [
        "bcc_dg_chiral_120", "bcc_dg_pseudo_120"]
    assert bench_matrix.select(["all"]) == rows
    assert bench_matrix.select(["fcc_chiral_100"]) == [rows[10]]


def test_matrix_default_out_is_not_the_tpu_record():
    out = os.path.relpath(bench_matrix.OUT, ROOT)
    assert out == os.path.join("bench_logs", "bench_matrix_torch.jsonl")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "bench_logs/bench_matrix_torch.jsonl" in f.read().split()


def test_run_row_has_the_jax_record_keys():
    run_row = next(node for node in _jax_tool().body
                   if isinstance(node, ast.FunctionDef)
                   and node.name == "run_row")
    ret = [n for n in ast.walk(run_row) if isinstance(n, ast.Return)][-1]
    keys = [k.value for k in ret.value.keys]
    rec = bench_matrix.run_row("sc_curv_chiral_120", LATTICE, "chiral", N,
                               19.85, 1, 500, device="cpu")
    assert list(rec) == keys + ["device"]
    assert rec["device"] == "cpu" and rec["n"] == N
    assert rec["validation"] <= 1e-3 and rec["iters"] > 0
    assert _is_ratio_of(rec["vs_baseline"], 19.85, rec["seconds"], 5e-4)


def test_matrix_resume_skips_only_this_devices_rows(tmp_path, monkeypatch):
    out = tmp_path / "m.jsonl"
    out.write_text(json.dumps({"row": "bcc_dg_chiral_120", "device": "cpu"})
                   + "\n" + json.dumps({"row": "bcc_dg_pseudo_120"}) + "\n"
                   + json.dumps({"row": "sc_curv_chiral_120",
                                 "device": "NVIDIA H100 80GB HBM3, 700.00 W"})
                   + "\n")
    assert bench_matrix.done_rows(str(out), "cpu") == {"bcc_dg_chiral_120"}
    ran = []

    def fake_row(key, *args):
        ran.append(key)
        if key == "sc_curv_pseudo_120":
            raise RuntimeError("status MAXITER")
        return {"row": key, "device": "cpu"}

    monkeypatch.setattr(bench_matrix, "run_row", fake_row)
    rows = ["bcc_dg_chiral_120", "bcc_dg_pseudo_120", "sc_curv_chiral_120"]
    assert bench_matrix.main(["--rows", *rows, "--out", str(out),
                              "--cpu"]) == 0
    assert ran == rows[1:]
    ran.clear()
    assert bench_matrix.main(["--rows", *rows, "sc_curv_pseudo_120",
                              "--out", str(out), "--cpu"]) == 1
    assert ran == ["sc_curv_pseudo_120"]
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(recs) == 5


@pytest.mark.parametrize("module", ["pcx_torch.bench",
                                    "pcx_torch.bench_matrix"])
def test_benchmarks_refuse_to_fall_back_to_the_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    r = _run(["-m", module, "--n", "8"] if module == "pcx_torch.bench"
             else ["-m", module, "--rows", "bcc_dg_chiral_120"])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr
    assert '"metric"' not in r.stdout and '"row"' not in r.stdout
