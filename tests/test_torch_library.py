"""The library pieces the experiments call, against the JAX package on the
same numpy inputs in complex128 / float64 on the CPU: the full-array
symbols and both forms of the penalized inverse, ``MaxwellProblem`` and
its assembly, ``plane_wave_block``, ``diag_block``, the dense operator
forms, the ``(x, a_apply)`` recompute, ``observed_order`` and
``print_standard_deviation``, the mask helpers and the mask cache, the
utilities, and ``profiling`` on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import config as jcfg
from pcx import geometry as jgeo
from pcx import lattices as jlat
from pcx import utils as jutils
from pcx import validate as jval
from pcx.operators import blocks as jblocks
from pcx.operators import dense as jdense
from pcx.operators import dielectric as jdiel
from pcx.operators import maxwell as jmax
from pcx.operators import symbols as jsym
from pcx_torch import config as tcfg
from pcx_torch import geometry as tgeo
from pcx_torch import utils as tutils
from pcx_torch import validate as tval
from pcx_torch.bandstructure import KPointSolver
from pcx_torch.operators import blocks as tblocks
from pcx_torch.operators import dense as tdense
from pcx_torch.operators import dielectric as tdiel
from pcx_torch.operators import maxwell as tmax
from pcx_torch.operators import symbols as tsym
from pcx_torch.profiling import phase_breakdown, trace

torch.set_num_threads(2)

# Symbols are closed-form elementwise products of the same stencil values:
# agreement to a few ulp of the largest entry (1e-12 relative).  The
# operator chains three block multiplies around two FFTs whose summation
# order differs (torch.fft vs XLA): 1e-12 relative as well.
SYM_RTOL = 1e-12
OP_RTOL = 1e-12
CPU = "cpu"


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _alpha(seed):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, 3)


def _block(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _curl(n, lattice, alpha, k=1, scal=1.0):
    """(JAX d_a numpy, port d_a tensor) of the full-array chain."""
    ct = jlat.ct_matrix(lattice)
    jd, jdi = jsym.curl_symbols(n, k, ct, scal=scal)
    td, tdi = tsym.curl_symbols(n, k, ct, scal=scal, device=CPU)
    assert _rel(td.numpy(), jd) <= SYM_RTOL
    assert _rel(tdi.numpy(), jdi) <= SYM_RTOL
    return (jsym.shift_symbol(jd, jdi, alpha, scal=scal),
            tsym.shift_symbol(td, tdi, alpha, scal=scal))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lattice", ["sc_curv", "fcc"])
def test_full_array_symbols_match_pcx(lattice, seed, k):
    n = 6
    alpha = _alpha(seed)
    (shift, _), pnt = tcfg.set_relaxation(alpha)
    jd_a, td_a = _curl(n, lattice, alpha, k=k, scal=1.5)
    assert td_a.shape == (3, n, n, n) and td_a.dtype == torch.complex128
    assert _rel(td_a.numpy(), jd_a) <= SYM_RTOL
    jb = jsym.penalty_symbol(jd_a)
    tb = tsym.penalty_symbol(td_a)
    for got, want in ((tb.diag, jb.diag), (tb.sdiag, jb.sdiag)):
        assert _rel(got.numpy(), want) <= SYM_RTOL
    # the JAX form of the penalized inverse, from the penalty symbol
    ji = jsym.inverse_penalized(jb, pnt, shift=shift)
    ti = tsym.inverse_penalized_b(tb, pnt, shift=shift)
    assert ti.diag.dtype == torch.float64
    for got, want in ((ti.diag, ji.diag), (ti.sdiag, ji.sdiag)):
        assert _rel(got.numpy(), want) <= SYM_RTOL
    # the main path's form, from the curl symbol, gives the same symbol
    tm = tsym.inverse_penalized(td_a, pnt, shift)
    for got, want in ((tm.diag, ji.diag), (tm.sdiag, ji.sdiag)):
        assert _rel(got.numpy(), want) <= SYM_RTOL
    jg = jsym.inverse_gram(jd_a, shift=0.5)
    tg = tsym.inverse_gram(td_a, shift=0.5)
    for got, want in ((tg.diag, jg.diag), (tg.sdiag, jg.sdiag)):
        assert _rel(got.numpy(), want) <= SYM_RTOL


@pytest.mark.parametrize("hermitian", [True, False])
def test_inverse_3x3_block_matches_pcx_and_inverts(hermitian):
    """The closed-form adjugate inverse against JAX's on a random
    Hermitian PD block field, and against numpy's inverse."""
    rng = np.random.default_rng(5)
    n = 4
    a = _block(rng, (n, n, n, 3, 3))
    h = a @ a.conj().swapaxes(-1, -2) + 3 * np.eye(3)
    diag = np.stack([h[..., i, i].real for i in range(3)])
    sdiag = np.stack([h[..., 0, 1], h[..., 0, 2], h[..., 1, 2]])
    want = jsym.inverse_3x3_block(diag, sdiag, shift=0.25,
                                  hermitian=hermitian)
    got = tsym.inverse_3x3_block(torch.as_tensor(diag),
                                 torch.as_tensor(sdiag), shift=0.25,
                                 hermitian=hermitian)
    assert _rel(got.diag.numpy(), want.diag) <= SYM_RTOL
    assert _rel(got.sdiag.numpy(), want.sdiag) <= SYM_RTOL
    inv = np.linalg.inv(h + 0.25 * np.eye(3))
    for c, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
        assert _rel(got.sdiag[c].numpy(), inv[..., i, j]) <= 1e-10
    assert _rel(got.diag[0].numpy(), inv[..., 0, 0]) <= 1e-10


@pytest.mark.parametrize("diel_type", ["chiral", "pseudochiral_crossdof"])
def test_assemble_problem_and_applies_match_pcx(diel_type):
    n, lattice = 6, "sc_curv"
    alpha = _alpha(3)
    cfg_j = jcfg.ProblemConfig(n=n, lattice=lattice, diel_type=diel_type,
                               scal=1.25)
    cfg_t = tcfg.ProblemConfig(n=n, lattice=lattice, diel_type=diel_type,
                               scal=1.25)
    jp = jmax.assemble_problem(cfg_j, alpha, dtype=jnp.complex128)
    tp = tmax.assemble_problem(cfg_t, alpha, dtype=torch.complex128,
                               device=CPU)
    assert isinstance(tp, torch.nn.Module)
    assert isinstance(tp.diel, tdiel.DielectricOp)
    assert "d_a" in dict(tp.named_buffers())
    assert tp.dof_shape == jp.dof_shape == (3, n, n, n)
    assert tp.shift == pytest.approx(jp.shift, rel=1e-15)
    assert tp.pnt == pytest.approx(jp.pnt, rel=1e-15)
    assert tp.alpha == pytest.approx(jp.alpha)
    assert _rel(tp.d_a.numpy(), jp.d_a) <= SYM_RTOL
    for got, want in ((tp.b, jp.b), (tp.inv, jp.inv)):
        assert _rel(got.diag.numpy(), want.diag) <= SYM_RTOL
        assert _rel(got.sdiag.numpy(), want.sdiag) <= SYM_RTOL
    x = _block(np.random.default_rng(8), (3, 3, n, n, n))
    xt = torch.as_tensor(x)
    for name in ("a_apply", "h_apply", "p_apply"):
        got = getattr(tp, name)(xt).numpy()
        want = np.asarray(getattr(jp, name)(jnp.asarray(x)))
        assert _rel(got, want) <= OP_RTOL, name


def test_assemble_symbols_casts_to_complex64():
    ct = jlat.ct_matrix("fcc")
    alpha = _alpha(6)
    (shift, _), pnt = tcfg.set_relaxation(alpha)
    d_a, b, inv = tmax.assemble_symbols(6, 1, ct, alpha, pnt, shift,
                                        dtype=torch.complex64, device=CPU)
    jd_a, jb, ji = jmax.assemble_symbols(6, 1, ct, alpha, pnt, shift,
                                         dtype=jnp.complex64)
    assert d_a.dtype == torch.complex64 and b.diag.dtype == torch.float32
    assert inv.sdiag.dtype == torch.complex64
    # each casts complex128 values that agree to 1e-12 once: one float32
    # rounding apart at most (2^-23 of the largest entry)
    for got, want in ((d_a, jd_a), (b.diag, jb.diag), (b.sdiag, jb.sdiag),
                      (inv.diag, ji.diag), (inv.sdiag, ji.sdiag)):
        assert _rel(got.numpy(), want) <= 2.0 ** -23


@pytest.mark.parametrize("m", [5, 8])
def test_plane_wave_block_matches_pcx(m):
    n = 6
    jd_a, td_a = _curl(n, "sc_curv", _alpha(2))
    want = np.asarray(jmax.plane_wave_block(jd_a, m))
    got = tmax.plane_wave_block(td_a, m, device=CPU)
    assert got.shape == (m, 3, n, n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # with a generator: the plane waves plus 1e-2 of a random block
    gen = torch.Generator().manual_seed(0)
    jit = tmax.plane_wave_block(td_a, m, device=CPU, gen=gen)
    assert 0 < float((jit - got).abs().max()) <= 1e-2 * 2 ** 0.5


def test_diag_block_matches_pcx():
    rng = np.random.default_rng(4)
    x = _block(rng, (2, 3, 4, 4, 4))
    d = _block(rng, (3, 4, 4, 4))
    got = tblocks.diag_block(torch.as_tensor(x), torch.as_tensor(d))
    want = np.asarray(jblocks.diag_block(jnp.asarray(x), jnp.asarray(d)))
    # one complex product, rounded by each library's own formula
    assert _rel(got.numpy(), want) <= 1e-15


@pytest.mark.parametrize("n", [4, 6])
@pytest.mark.parametrize("diel_type", ["pseudochiral_trivial",
                                       "pseudochiral_crossdof"])
def test_materialize_and_dense_checks_match_pcx(diel_type, n):
    """The dense eps^{-1} through both packages (the operators apply the
    same stencil to the same masks: 1e-14 of the largest entry; at N=6,
    3N^3 = 648 columns take two chunks), its SDD census against the
    matrix-free one, and the difference report of the two
    constructions."""
    jop = jdiel.build(diel_type, n, "sc_curv")
    top = tdiel.build(diel_type, n, "sc_curv", CPU)
    want = jdense.materialize(jop, n)
    got = tdense.materialize(top, n, device=CPU)
    assert got.shape == (3 * n ** 3,) * 2
    assert _rel(got, want) <= 1e-14
    n_bad = tdense.check_sdd_dense(got, verbose=False)
    assert n_bad == jdense.check_sdd_dense(want, verbose=False)
    assert n_bad == top.sdd_violations()
    other = tdense.materialize(tdiel.build("pseudochiral_trivial", n,
                                           "sc_curv", CPU), n, device=CPU)
    rep_t = tdense.dense_diff_report(got, other, verbose=False)
    rep_j = jdense.dense_diff_report(want, jdense.materialize(
        jdiel.build("pseudochiral_trivial", n, "sc_curv"), n), verbose=False)
    assert rep_t["size"] == rep_j["size"] and rep_t["nnz"] == rep_j["nnz"]
    for key in ("fro", "max_nz", "min_nz", "spectral_radius"):
        assert rep_t[key] == pytest.approx(rep_j[key], rel=1e-10, abs=1e-14)


def test_recompute_x_a_apply_form_matches_pcx():
    """The (x, a_apply) recompute on a crafted block: Rayleigh quotients,
    residuals and frequencies to 1e-12 relative, and the spurious gate."""
    n, lattice = 6, "sc_curv"
    alpha = _alpha(9)
    cfg = tcfg.ProblemConfig(n=n, lattice=lattice)
    tp = tmax.assemble_problem(cfg, alpha, device=CPU)
    jp = jmax.assemble_problem(jcfg.ProblemConfig(n=n, lattice=lattice),
                               alpha)
    x = _block(np.random.default_rng(10), (4, 3, n, n, n))
    xt = torch.as_tensor(x)
    lam_re = (tutils.dots(xt, tp.a_apply(xt)) / tutils.dots(xt, xt)).real
    lam = lam_re.numpy() * (1 + 1e-5) + tp.shift
    kw = dict(shift=tp.shift, raise_on_spurious=False)
    want = jval.recompute(lam, jnp.asarray(x), jp.a_apply, **kw)
    got = tval.recompute(lam, xt, tp.a_apply, **kw)
    for f in ("omega_pnt", "omega_re", "residuals"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-12, f
    assert got.spurious == want.spurious is False
    with pytest.raises(tval.SpuriousModeError):
        tval.recompute(lam * 1.5, xt, tp.a_apply, shift=tp.shift)


def test_observed_order():
    # Second-order model: f(N) = f* + c / N^2 (tests/test_metrics_profiling.py)
    freqs = {n: np.array([1.0 + 4.0 / n ** 2, 2.0 - 1.0 / n ** 2])
             for n in (16, 32, 64, 128)}
    orders = tval.observed_order(freqs, verbose=False)
    np.testing.assert_allclose(orders, 2.0, atol=1e-10)
    np.testing.assert_array_equal(orders,
                                  jval.observed_order(freqs, verbose=False))
    with pytest.raises(ValueError):
        tval.observed_order({8: [1.0], 16: [1.0]})


def test_print_standard_deviation(capsys):
    rng = np.random.default_rng(11)
    a, b = rng.random((3, 4)), rng.random((3, 4))
    got = tval.print_standard_deviation(a, b, 3)
    out_t = capsys.readouterr().out
    want = jval.print_standard_deviation(a, b, 3)
    assert capsys.readouterr().out == out_t
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mask_index_roundtrip_matches_pcx():
    rng = np.random.default_rng(3)
    mask = rng.random((3, 5, 5, 5)) < 0.3
    ind = tgeo.mask_to_indices(mask)
    np.testing.assert_array_equal(ind, jgeo.mask_to_indices(mask))
    np.testing.assert_array_equal(tgeo.indices_to_mask(ind, 5, "edge"), mask)
    assert np.all(np.diff(ind) > 0) and ind.dtype == np.int64
    vol = mask[0]
    vind = tgeo.mask_to_indices(vol)
    np.testing.assert_array_equal(vind, jgeo.mask_to_indices(vol))
    np.testing.assert_array_equal(tgeo.indices_to_mask(vind, 5, "volume"),
                                  vol)


@pytest.mark.parametrize("lattice", ["sc_curv", "fcc", None])
def test_volume_adjacent_edge_masks_match_pcx(lattice, tmp_path, monkeypatch):
    monkeypatch.setattr(jgeo, "CACHE_DIR", str(tmp_path / "j"))
    monkeypatch.setattr(tgeo, "CACHE_DIR", str(tmp_path / "t"))
    got = tgeo.volume_adjacent_edge_masks(8, lattice)
    assert got.shape == (3, 8, 8, 8) and got.dtype == bool
    np.testing.assert_array_equal(got,
                                  jgeo.volume_adjacent_edge_masks(8, lattice))


def test_mask_cache_round_trip_shared_with_pcx(tmp_path, monkeypatch):
    """Masks written by the port read back identical, in the JAX
    package's file format (each package reads the other's files), and
    an unreadable file is rebuilt."""
    monkeypatch.setattr(tgeo, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jgeo, "CACHE_DIR", str(tmp_path))
    m1 = tgeo.edge_mask(8, "sc_flat1")
    path = os.path.join(str(tmp_path), "sc_flat1_8_edge.npz")
    assert os.path.exists(path) and m1.shape == (3, 8, 8, 8)
    assert sorted(os.listdir(tmp_path)) == ["sc_flat1_8_edge.npz"]
    np.testing.assert_array_equal(tgeo.edge_mask(8, "sc_flat1"), m1)
    np.testing.assert_array_equal(jgeo.edge_mask(8, "sc_flat1"), m1)
    jv = jgeo.volume_mask(8, "sc_curv", use_native=False)
    assert os.path.exists(tgeo._cache_path("sc_curv", 8, "volume"))
    np.testing.assert_array_equal(tgeo.volume_mask(8, "sc_curv"), jv)
    np.testing.assert_array_equal(
        tgeo.volume_mask(8, "sc_curv", cache=False), jv)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    np.testing.assert_array_equal(tgeo.edge_mask(8, "sc_flat1"), m1)
    np.testing.assert_array_equal(jgeo.edge_mask(8, "sc_flat1"), m1)


def test_cache_dir_follows_the_environment(tmp_path):
    """CACHE_DIR is $PCX_GEOMETRY_CACHE, else data/geometry_cache of the
    checkout, as in pcx."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PCX_GEOMETRY_CACHE"}
    env["PYTHONPATH"] = root
    cmd = [sys.executable, "-c",
           "import pcx_torch.geometry as g; print(g.CACHE_DIR)"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == os.path.join(root, "data", "geometry_cache")
    out = subprocess.run(cmd, env=dict(env, PCX_GEOMETRY_CACHE=str(tmp_path)),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(tmp_path)


def test_config_and_utils_match_pcx():
    assert tcfg.TYPE_PSEUDO_CROSSDOF2 == jcfg.TYPE_PSEUDO_CROSSDOF2
    x = _block(np.random.default_rng(12), (3, 2, 4, 5))
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(tutils.as_blockvec(xt).numpy(),
                                  np.asarray(jutils.as_blockvec(x)))
    assert float(tutils.norm(xt)) == pytest.approx(float(jutils.norm(x)),
                                                   rel=1e-14)
    assert float(tutils.norm(x)) == pytest.approx(float(jutils.norm(x)),
                                                  rel=1e-14)
    tree = {"a": [xt, (xt, 1)], "b": None}
    assert tutils.block_until_ready(tree) is tree


def test_phase_breakdown_and_trace_on_cpu(tmp_path):
    """profiling on the CPU (tests/test_metrics_profiling.py's smoke test):
    every phase's time positive and within the measured iteration, device
    memory not measured (NaN), the solver's cap restored, and a trace
    written."""
    solver = KPointSolver(tcfg.ProblemConfig(n=8, lattice="sc_curv", nev=4),
                          device=CPU, dtype=torch.complex64)
    out = phase_breakdown(solver, np.array([np.pi, 0, 0]), repeats=2,
                          verbose=False)
    phases = ("operator_s", "precond_s", "gram_rr_s", "ortho_s")
    for k in phases + ("iteration_s",):
        assert out[k] > 0
    assert sum(out[k] for k in phases) < out["iteration_s"]
    assert np.isnan(out["memory_mib"])
    assert solver.maxiter == tcfg.MAXITER
    got = trace(lambda a: a * 2, torch.ones(3), logdir=str(tmp_path))
    assert torch.equal(got, torch.full((3,), 2.0))
    assert os.path.getsize(tmp_path / "trace.json") > 0
