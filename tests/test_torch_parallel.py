"""The port's multi-card pieces (``pcx_torch.parallel``, ``solve_batch``
and ``bandgap(k_batch=, mesh=)``) against the JAX package's
(tests/test_parallel.py), on the CPU over gloo.

JAX runs in this process on its 8 virtual CPU devices (tests/conftest.py);
the port runs in 1, 2 or 4 rank processes started by ``spawn``, which meet
through a FileStore in the test's temporary directory (no port to race
for), with a 60 s process-group timeout.  Each launch is joined with a
hard timeout, after which its ranks are killed and the test fails: a hang
costs one test, not the suite.  The rank bodies are module-level functions
of this file, which imports ``jax`` and ``pcx`` only inside test bodies,
so that a rank loads neither; each rank writes its result to a pickle in
the temporary directory.  Both sides run in complex128.
"""

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
import multiprocessing as mp

import numpy as np
import pytest
import torch

# Two intra-op threads in this process (the serial solves), one per rank.
torch.set_num_threads(min(torch.get_num_threads(), 2))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 120.0
PG_TIMEOUT = datetime.timedelta(seconds=60)
N, NEV = 8, 4
ALPHA = np.array([np.pi, 0.0, 0.0])
SWEEP = dict(n=8, lattice="sc_flat1", nev=4, gap=4)
# Eight rows of the sc_flat1 gap-4 path in groups of two: [6, 7] starts
# away from 3, the last index before it, so it starts cold.
SWEEP_ROWS = [0, 1, 2, 3, 6, 7, 8, 9]


# ---------------------------------------------------------------------------
# The rank harness.
# ---------------------------------------------------------------------------

def _rank_main(body, rank, world, out_dir, env, args):
    os.environ.update(env)
    torch.set_num_threads(1)
    from pcx_torch.parallel.mesh import init_distributed
    import torch.distributed as dist
    try:
        if env:   # torchrun's variables name the rendezvous
            got = init_distributed(device_type="cpu", timeout=PG_TIMEOUT)
        else:
            got = init_distributed(f"file://{out_dir}/store", world, rank,
                                   device_type="cpu", timeout=PG_TIMEOUT)
        assert got == rank, (got, rank)
        result = body(rank, world, out_dir, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start(body, world, out_dir, *args, env_for=None):
    """Start ``body(rank, world, out_dir, *args)`` on ``world`` spawned
    ranks; ``env_for(rank)`` gives torchrun-style variables instead of the
    FileStore.  Returns what ``_join`` takes."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, world, str(out_dir),
                               env_for(r) if env_for else {}, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, str(out_dir), time.time() + JOIN_TIMEOUT


def _launch(body, world, out_dir, *args, env_for=None):
    """Run ``body`` on ``world`` ranks and return their results."""
    return _join(_start(body, world, out_dir, *args, env_for=env_for))


def _join(started):
    """Wait for the ranks until their deadline, kill any still running, and
    return their results; fail on a hang or on a rank's error."""
    procs, out_dir, deadline = started
    world = len(procs)
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {}
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            errors[r] = open(path).read()
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT} s; " \
                     f"errors: {errors}"
    assert all(p.exitcode == 0 for p in procs), errors
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _grid_mesh(world):
    from pcx_torch.parallel.mesh import make_mesh
    return make_mesh(n_grid=world, device_type="cpu")


# ---------------------------------------------------------------------------
# Rank bodies.
# ---------------------------------------------------------------------------

def _body_pencil(rank, world, out_dir, x):
    from pcx_torch.parallel import fft as pfft
    from pcx_torch.parallel.mesh import gather_shards, local_shard
    group = _grid_mesh(world).get_group("grid")
    xl = local_shard(torch.as_tensor(x), -1, group)
    y = pfft.pencil_fftn(xl, group)
    back = pfft.pencil_ifftn(y, group)
    return (gather_shards(y, -3, group).numpy(),
            gather_shards(back, -1, group).numpy(), tuple(y.shape))


def _body_roll(rank, world, out_dir, a, shifts):
    from pcx_torch.parallel import fft as pfft
    from pcx_torch.parallel.mesh import gather_shards, local_shard
    group = _grid_mesh(world).get_group("grid")
    al = local_shard(torch.as_tensor(a), 0, group)
    return [gather_shards(pfft.sharded_roll(al, s, 0, group), 0,
                          group).numpy() for s in shifts]


def _body_crossdof(rank, world, out_dir, x, diag, masks, sten, eps):
    from pcx_torch.parallel.mesh import gather_shards, local_shard
    from pcx_torch.parallel.solve import make_sharded_crossdof
    group = _grid_mesh(world).get_group("grid")
    fn = make_sharded_crossdof(
        local_shard(torch.as_tensor(diag), -3, group),
        local_shard(torch.as_tensor(masks), -3, group), sten, *eps, group)
    y = fn(local_shard(torch.as_tensor(x), -3, group))
    return gather_shards(y, -3, group).numpy()


def _body_sharded_solve(rank, world, out_dir, d_a, b, inv, scale, shift, x0,
                        nev):
    from pcx_torch.parallel.mesh import gather_shards
    from pcx_torch.parallel.solve import solve_kpoint_sharded
    mesh = _grid_mesh(world)
    res = solve_kpoint_sharded(mesh, d_a, b, inv, scale, shift,
                               torch.as_tensor(x0), nev, tol=1e-6,
                               maxiter=300)
    x = gather_shards(res.x, -1, mesh.get_group("grid"))
    return (res.lambdas.numpy(), res.iterations, res.status,
            res.res_history, tuple(res.x.shape), x.numpy())


def _body_solve_batch(rank, world, out_dir, alphas):
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device_type="cpu")          # all ranks on the k axis
    s = KPointSolver(ProblemConfig(n=N, lattice="sc_flat1", nev=NEV),
                     device="cpu", dtype=torch.complex128)
    out = {}
    for name, group in (("full", alphas), ("ragged", alphas[:3])):
        res = s.solve_batch(group, seed=0, mesh=mesh)
        out[name] = [(r.omega_re, r.iterations, r.status, r.wall_time,
                      None if r.x is None else r.x.numpy()) for r in res]
    return out


def _body_bandgap(rank, world, out_dir):
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device_type="cpu")
    mine = os.path.join(out_dir, f"out{rank}")
    err = bandgap(output_dir=mine, metrics_path=mine + ".jsonl",
                  indices=SWEEP_ROWS, verbose=False, mesh=mesh,
                  device="cpu", dtype=torch.complex128, **SWEEP)
    return err


def _body_torchrun(rank, world, out_dir):
    import torch.distributed as dist
    from pcx_torch.parallel.mesh import (K_AXIS, axis_size, host_slice,
                                         local_shard, make_multihost_mesh)
    mesh = make_multihost_mesh(n_grid=1, device_type="cpu")
    total = local_shard(torch.arange(8.0), 0, mesh.get_group(K_AXIS)).sum()
    dist.all_reduce(total, group=mesh.get_group(K_AXIS))
    try:
        make_multihost_mesh(n_grid=3, device_type="cpu")
        refused = False
    except ValueError:
        refused = True
    return (axis_size(mesh, K_AXIS), float(total), host_slice(10), refused)


def _lobpcg_problem():
    """A seeded Hermitian positive definite operator (48 x 48) and start
    block for the solver's bit-identity check."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(48, 48)) + 1j * rng.normal(size=(48, 48))
    h = torch.as_tensor(a @ a.conj().T / 48 + np.diag(np.arange(48.0)))
    x0 = torch.as_tensor(rng.normal(size=(6, 48)) + 1j
                         * rng.normal(size=(6, 48)))
    return (lambda v: v @ h.T), x0


def _body_lobpcg(rank, world, out_dir):
    import torch.distributed as dist
    from pcx_torch.solvers.lobpcg import lobpcg_sep
    h, x0 = _lobpcg_problem()
    out = []
    for kw in ({}, {"reduce_axis": None}, {"reduce_axis": dist.group.WORLD}):
        for rr_mode in ("auto", "f64"):
            r = lobpcg_sep(h, lambda v: v, x0, 3, tol=1e-8, maxiter=60,
                           rr_mode=rr_mode, **kw)
            out.append((r.lambdas.numpy(), r.x.numpy(), r.iterations,
                        r.status, r.res_history))
    return out


# ---------------------------------------------------------------------------
# Tests.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_pencil_fft_matches_numpy(tmp_path, world):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, N, N, N)) + 1j * rng.normal(size=(2, 3, N, N, N))
    outs = _launch(_body_pencil, world, tmp_path, x)
    want = np.fft.fftn(x, axes=(-3, -2, -1))
    for y, back, shape in outs:
        assert shape == (2, 3, N // world, N, N)
        np.testing.assert_allclose(y, want, atol=1e-10)
        np.testing.assert_allclose(back, x, atol=1e-10)


def test_sharded_roll_matches_roll(tmp_path):
    """Four ranks of two rows each; shifts up to 3 cross two shards."""
    a = np.random.default_rng(9).normal(size=(8, 3))
    shifts = list(range(-3, 4))
    for got in _launch(_body_roll, 4, tmp_path, a, shifts):
        for s, y in zip(shifts, got):
            np.testing.assert_array_equal(y, np.roll(a, s, axis=0))


def test_sharded_crossdof_apply_matches_pcx(tmp_path):
    """The halo-exchange cross-DoF eps^-1 (x-sharded, stencil k=2: two-plane
    halos) against pcx's single-device pseudochiral_crossdof_op."""
    from pcx import geometry, stencils
    from pcx.config import CHIRAL_EPS_EG, PSEUDOCHIRAL_EPS_LOC
    from pcx.operators import dielectric as jdiel
    k, lattice = 2, "sc_curv"
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, N, N, N)) + 1j * rng.normal(size=(2, 3, N, N, N))
    want = np.asarray(jdiel.pseudochiral_crossdof_op(N, lattice, k=k)(x))
    eps_loc = PSEUDOCHIRAL_EPS_LOC[0] / CHIRAL_EPS_EG[lattice]
    em = geometry.edge_mask(N, lattice, use_native=False)
    diag = np.stack([np.where(em[c], eps_loc[c].real, 1.0) for c in range(3)])
    sten = tuple(float(w) for w in stencils.mfd_stencil(k, 0))
    eps = tuple(complex(e) for e in eps_loc[3:6])
    for got in _launch(_body_crossdof, 2, tmp_path, x, diag,
                       em.astype(np.float64), sten, eps):
        np.testing.assert_allclose(got, want, atol=1e-12)


def _sharded_case(name):
    """(JAX single-device KPointSolver, symbols, the port's scale argument,
    the JAX one) of a grid-sharded solve case at n=8, alpha=(pi,0,0)."""
    import jax.numpy as jnp
    from pcx import geometry
    from pcx.bandstructure import KPointSolver
    from pcx.config import CHIRAL_EPS_EG, PSEUDOCHIRAL_EPS_LOC, ProblemConfig
    lattice, diel, nev = (("sc_flat1", "chiral", NEV) if name == "chiral"
                          else ("sc_curv", "pseudochiral_trivial", 3))
    single = KPointSolver(ProblemConfig(n=N, lattice=lattice,
                                        diel_type=diel, nev=nev),
                          dtype=jnp.complex128)
    em = geometry.edge_mask(N, lattice, use_native=False)
    if name == "chiral":
        scale = np.where(em, 1.0 / CHIRAL_EPS_EG[lattice], 1.0)
        jscale = jnp.asarray(scale)
    else:
        eps_loc = PSEUDOCHIRAL_EPS_LOC[0] / CHIRAL_EPS_EG[lattice]
        vm = geometry.volume_mask(N, lattice, use_native=False)
        scale = (np.stack([np.where(em[c], eps_loc[c].real, 1.0)
                           for c in range(3)]),
                 np.stack([np.where(vm, eps_loc[3 + c], 0.0)
                           for c in range(3)]))
        jscale = tuple(jnp.asarray(a) for a in scale)
    return single, nev, scale, jscale


SHARDED_CASES = ("chiral", "pseudochiral_trivial")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both grid-sharded cases: the port's two-rank solves, started first,
    then pcx's sharded solves on a 2x2 mesh (in two threads: XLA compiles
    them at once, ~50 s) and pcx's single-device solves, all from one
    numpy start block per case."""
    import jax
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor
    from pcx.parallel.mesh import make_mesh
    from pcx.parallel.solve import solve_kpoint_sharded
    cases, started = {}, {}
    for case in SHARDED_CASES:
        single, nev, scale, jscale = _sharded_case(case)
        d_a, b, inv, shift = single.symbols_for(ALPHA)
        rng = np.random.default_rng(11)
        shape = (nev + 2, 3, N, N, N)
        x0 = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        sym = [np.asarray(d_a), tuple(np.asarray(a) for a in b),
               tuple(np.asarray(a) for a in inv)]
        started[case] = _start(_body_sharded_solve, 2,
                               tmp_path_factory.mktemp(case), *sym, scale,
                               float(shift), x0, nev)
        cases[case] = (single, nev, jscale, d_a, b, inv, shift, x0)
    mesh4 = make_mesh(n_k=2, n_grid=2, devices=jax.devices()[:4])

    def jax_sharded(case):
        _, nev, jscale, d_a, b, inv, shift, x0 = cases[case]
        r = solve_kpoint_sharded(mesh4, d_a, b, inv, jscale, shift,
                                 jnp.asarray(x0), nev, tol=1e-6, maxiter=300)
        return np.asarray(r.lambdas)[:nev] - shift

    with ThreadPoolExecutor(len(SHARDED_CASES)) as ex:
        futs = {c: ex.submit(jax_sharded, c) for c in SHARDED_CASES}
        out = {}
        for case in SHARDED_CASES:
            single, nev, _, _, _, _, shift, x0 = cases[case]
            r1 = single.solve(ALPHA, x0=jnp.asarray(x0),
                              validate_result=False)
            out[case] = dict(nev=nev, shift=shift,
                             single=np.asarray(r1.lambdas)[:nev])
        for case in SHARDED_CASES:
            out[case]["jax"] = futs[case].result()
    for case in SHARDED_CASES:
        out[case]["port"] = _join(started[case])
    return out


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_solve_kpoint_sharded_matches_pcx(sharded, case):
    """Two grid ranks: the port's sharded solve against pcx's on a 2x2 mesh
    and against pcx's single-device solve, from one numpy start block, at
    pcx's own bound; every rank returns the same iterations, status and
    history."""
    ref = sharded[case]
    nev, shift, outs = ref["nev"], ref["shift"], ref["port"]
    lam, its, status, his, xshape, _ = outs[0]
    assert xshape == (nev + 2, 3, N, N, N // 2)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0], lam)
        assert (o[1], o[2]) == (its, status)
        np.testing.assert_array_equal(o[3], his)
    assert status == 1, status
    for want in (ref["jax"], ref["single"]):
        np.testing.assert_allclose(lam[:nev] - shift, want, rtol=5e-5,
                                   atol=1e-6)


def test_solve_batch_mesh_matches_serial(tmp_path):
    """solve_batch(mesh=) on a two-rank k axis, a full and a ragged group:
    every member within 1e-8 of the port's serial solve from the same seed
    (pcx's bound) and within 1e-9 of pcx's serial omega_re; x stays on its
    rank except the last member's, which every rank holds."""
    import jax.numpy as jnp
    from pcx import lattices as jlat
    from pcx.bandstructure import KPointSolver as JaxSolver
    from pcx.config import ProblemConfig as JaxConfig
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    alphas = list(jlat.k_path("sc_flat1", gap=4)[1:5])
    outs = _launch(_body_solve_batch, 2, tmp_path, alphas)
    s = KPointSolver(ProblemConfig(n=N, lattice="sc_flat1", nev=NEV),
                     device="cpu", dtype=torch.complex128)
    serial = [s.solve(a, seed=i) for i, a in enumerate(alphas)]
    js = JaxSolver(JaxConfig(n=N, lattice="sc_flat1", nev=NEV),
                   dtype=jnp.complex128)
    jax_serial = [np.asarray(js.solve(a, seed=0).omega_re) for a in alphas]
    for name, n_req in (("full", 4), ("ragged", 3)):
        for rank, out in enumerate(outs):
            got = out[name]
            assert len(got) == n_req
            walls = {w for _, _, _, w, _ in got}
            assert len(walls) == 1
            for i, (om, its, status, _, x) in enumerate(got):
                np.testing.assert_allclose(om, serial[i].omega_re, rtol=0,
                                           atol=1e-8)
                np.testing.assert_allclose(om, jax_serial[i], rtol=0,
                                           atol=1e-9)
                assert status in (1, 5)
                # members 0..1 solve on rank 0, the rest on rank 1
                held = i == n_req - 1 or i // 2 == rank
                assert (x is not None) == held, (name, rank, i)
        np.testing.assert_array_equal(outs[0][name][-1][4],
                                      outs[1][name][-1][4])


@pytest.fixture(scope="module")
def jax_sweeps(tmp_path_factory):
    """pcx's serial sweep and its k_batch=2 sweep of SWEEP_ROWS."""
    from pcx.bandstructure import bandgap as jbandgap
    out = tmp_path_factory.mktemp("jax_sweeps")
    libs = {}
    for name, kw in (("serial", {}), ("k_batch", {"k_batch": 2})):
        err = jbandgap(output_dir=str(out / name), indices=SWEEP_ROWS,
                       verbose=False, **SWEEP, **kw)
        assert err == []
        with open(out / name / "chiral/bandgap_sc_flat1.json") as f:
            libs[name] = json.load(f)
    return libs


def _assert_library_matches(path, want):
    with open(path) as f:
        got = json.load(f)
    key_it, key_fq = "sc_flat1_8_iterations", "sc_flat1_8_frequencies"
    done = [i for i, r in enumerate(got[key_it]) if r[0] > 0]
    assert done == SWEEP_ROWS
    assert [i for i, r in enumerate(want[key_it]) if r[0] > 0] == done
    np.testing.assert_allclose(np.asarray(got[key_fq]),
                               np.asarray(want[key_fq]), rtol=0, atol=1e-6)


def test_bandgap_mesh_matches_pcx_sweep(tmp_path, jax_sweeps):
    """bandgap(mesh=) on a two-rank k axis (k_batch 2 by default): the
    library within 1e-6 of pcx's serial sweep, record for record.  Each
    rank is given its own output directory: only rank 0's library and
    metrics file may exist."""
    errs = _launch(_body_bandgap, 2, tmp_path)
    assert errs == [[], []]
    _assert_library_matches(tmp_path / "out0/chiral/bandgap_sc_flat1.json",
                            jax_sweeps["serial"])
    assert not (tmp_path / "out1").exists()
    assert os.path.exists(tmp_path / "out0.jsonl")
    assert not os.path.exists(tmp_path / "out1.jsonl")
    with open(tmp_path / "out0.jsonl") as f:
        assert len(f.readlines()) == len(SWEEP_ROWS)


def test_bandgap_k_batch_matches_pcx(tmp_path, jax_sweeps):
    """bandgap(k_batch=2) on one device against pcx's bandgap(k_batch=2)."""
    from pcx_torch.bandstructure import bandgap
    err = bandgap(output_dir=str(tmp_path), indices=SWEEP_ROWS, k_batch=2,
                  verbose=False, device="cpu", dtype=torch.complex128,
                  **SWEEP)
    assert err == []
    _assert_library_matches(tmp_path / "chiral/bandgap_sc_flat1.json",
                            jax_sweeps["k_batch"])


def test_init_distributed_with_torchrun_variables(tmp_path):
    """init_distributed from torchrun's variables, make_multihost_mesh and
    host_slice (tests/test_parallel.py:234-284): the k-sharded sum of
    arange(8) is 28, host_slice(10) is range(rank, 10, 2), and a grid axis
    wider than the cards per host is refused."""
    from pcx_torch.parallel.mesh import init_distributed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def env_for(rank):
        return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                "WORLD_SIZE": "2", "RANK": str(rank),
                "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": "2"}

    outs = _launch(_body_torchrun, 2, tmp_path, env_for=env_for)
    for rank, (n_k, total, mine, refused) in enumerate(outs):
        assert n_k == 2 and total == 28.0 and refused
        assert mine == list(range(rank, 10, 2))
    saved = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE",
                                            "RANK") if k in os.environ}
    try:
        assert init_distributed(device_type="cpu") == 0   # nothing set
    finally:
        os.environ.update(saved)


def test_lobpcg_sep_without_reduce_axis_is_unchanged(tmp_path):
    """Without reduce_axis (or with None) the solver runs the code it ran
    before the mesh reduction: the same bits, in both Rayleigh-Ritz modes.
    Over a one-rank group it takes the reduced path, whose norms are square
    roots of sums of squares, to rounding."""
    (out,) = _launch(_body_lobpcg, 1, tmp_path)
    for k in range(2):
        ref = out[k]
        for a, b in zip(ref, out[2 + k]):
            np.testing.assert_array_equal(a, b)
        grp = out[4 + k]
        assert ref[2:4] == grp[2:4] and ref[3] == 1
        np.testing.assert_allclose(grp[0], ref[0], rtol=1e-12)


def test_run_sweep_worker_passes_k_batch(tmp_path, monkeypatch):
    """python -m pcx_torch.run_sweep --k-batch 2: the worker's bandgap call
    takes k_batch=2 and completes a library of pending rows."""
    from pcx_torch import run_sweep
    from pcx_torch.io import BandLibrary
    spawned = []

    class Outcome:
        ok = True

    monkeypatch.setattr(run_sweep.subprocess, "Popen",
                        lambda args, env: spawned.append(args))
    monkeypatch.setattr(run_sweep, "supervise",
                        lambda spawn, *a, **k: (spawn(), Outcome)[1])
    out = tmp_path / "out"
    path = out / "chiral/bandgap_sc_flat1.json"
    lib = BandLibrary(str(path), "sc_flat1", 8, 4, 4)
    lib.record(3, 7, 0.5, np.arange(4) * 0.1)
    assert run_sweep.main(["--n", "8", "--lattice", "sc_flat1", "--gap", "1",
                           "--nev", "4", "--device", "cpu", "--k-batch", "2",
                           "--output", str(out)]) == 0
    monkeypatch.undo()   # the real subprocess.Popen again
    worker = spawned[0][-1]
    assert "k_batch=2" in worker
    r = subprocess.run([sys.executable, "-c", worker], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    its = json.loads(path.read_text())["sc_flat1_8_iterations"]
    assert all(it[0] > 0 for it in its) and its[3] == [7.0, 0.5]
