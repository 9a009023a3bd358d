"""The port's solver stack against the JAX package's on identical numpy
state: the Rayleigh-Ritz algebra, the production LOBPCG through
``KPointSolver.solve`` (complex128, and complex64 with the kernels' plain
versions vs the Pallas kernels in interpret mode), the complex128 refine,
``validate.recompute`` and the status codes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcx import boundary
from pcx import validate as jval
from pcx.bandstructure import KPointSolver as JaxSolver
from pcx.config import ProblemConfig as JaxConfig
from pcx.operators import dielectric as jdiel
from pcx.operators import rs
from pcx.solvers import lobpcg as jlob
from pcx.solvers import rayleigh_ritz as jrr
from pcx_torch import interop
from pcx_torch import validate as tval
from pcx_torch.bandstructure import KPointSolver, eigen_1p
from pcx_torch.config import ProblemConfig
from pcx_torch.operators import maxwell as tmax
from pcx_torch.operators import symbols as tsym
from pcx_torch.solvers import lobpcg as tlob
from pcx_torch.solvers import rayleigh_ritz as trr

# Every parallel test worker imports this file.  The problems here are
# small, so two intra-op threads per process do; the default (one per core
# in each worker) oversubscribes the cores several times over.
torch.set_num_threads(min(torch.get_num_threads(), 2))

# Dense algebra in complex128 / f64 on both sides, other summation order.
ALG_TOL = 1e-12


def _pair(a):
    a = np.asarray(a)
    return (jnp.asarray(a.real), jnp.asarray(a.imag))


def _cplx(p):
    return np.asarray(p[0]) + 1j * np.asarray(p[1])


def _blk(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _projector(q, mask):
    q = q[np.asarray(mask) > 0.5]
    return q.T @ q.conj()


def test_gram_colnorms_mix_match_rayleigh_ritz(rng):
    x, y = _blk(rng, 6, 3000), _blk(rng, 4, 3000)
    c = _blk(rng, 6, 5)
    g = trr.gram_f64(torch.as_tensor(x), torch.as_tensor(y), chunk=700)
    want = _cplx(jrr.gram_f64_p(_pair(x), _pair(y), chunk=700))
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=ALG_TOL *
                               np.abs(want).max())
    np.testing.assert_allclose(trr.gram(torch.as_tensor(x),
                                        torch.as_tensor(y)).numpy(), want,
                               rtol=0, atol=ALG_TOL * np.abs(want).max())
    np.testing.assert_allclose(trr.colnorms(torch.as_tensor(x)).numpy(),
                               np.asarray(jrr.colnorms_p(_pair(x))),
                               rtol=ALG_TOL)
    mixed = _cplx(jrr.mix_pair(_pair(c), _pair(x)))
    np.testing.assert_allclose(
        trr.mix(torch.as_tensor(c), torch.as_tensor(x)).numpy(), mixed,
        rtol=0, atol=ALG_TOL * np.abs(mixed).max())


def test_gram_f64_complex64_partials_sum_in_complex128(rng):
    x = _blk(rng, 3, 4096).astype(np.complex64)
    g = trr.gram_f64(torch.as_tensor(x), torch.as_tensor(x))
    assert g.dtype == torch.complex128
    want = _cplx(jrr.gram_f64_p((jnp.asarray(x.real), jnp.asarray(x.imag)),
                                (jnp.asarray(x.real), jnp.asarray(x.imag))))
    np.testing.assert_allclose(g.numpy(), want, rtol=2e-6)


@pytest.mark.parametrize("with_against", [False, True])
def test_masked_svqb_drop_matches_rayleigh_ritz(rng, with_against):
    """A rank-deficient block (two columns are combinations of others):
    the same directions are dropped, and the kept rows span the same
    space, orthonormal."""
    d = 400
    b = _blk(rng, 6, d)
    b[4] = b[0] + 2j * b[1]
    b[5] = 0.5 * b[2] - b[3]
    hb = _blk(rng, 6, d)
    mask = np.ones(6)
    kw, tkw = {}, {}
    if with_against:
        base = np.linalg.qr(_blk(rng, d, 2))[0].T.copy()
        hbase = _blk(rng, 2, d)
        kw = dict(against=(_pair(base),), h_against=(_pair(hbase),))
        tkw = dict(against=(torch.as_tensor(base),),
                   h_against=(torch.as_tensor(hbase),))
    q, hq, keep = jrr.masked_svqb_drop_p(_pair(b), jnp.asarray(mask), 1e-6,
                                         hblock=_pair(hb), passes=2, **kw)
    tq, thq, tkeep = trr.masked_svqb_drop(
        torch.as_tensor(b), torch.as_tensor(mask), 1e-6,
        hblock=torch.as_tensor(hb), passes=2, **tkw)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    assert int(tkeep.sum()) == 4
    q, tq = _cplx(q), tq.numpy()
    np.testing.assert_allclose(_projector(tq, tkeep), _projector(q, keep),
                               atol=ALG_TOL * 10)
    kept = tq[tkeep.numpy() > 0.5]
    np.testing.assert_allclose(kept.conj() @ kept.T, np.eye(4), atol=1e-12)
    # hblock follows the same row combinations: M = conj(Q) HQ^T over the
    # kept rows changes by a unitary similarity between the two gauges, so
    # its trace and Frobenius norm agree.
    def invariants(qq, hq, kk):
        sel = np.asarray(kk) > 0.5
        m = qq[sel].conj() @ np.asarray(hq)[sel].T
        return np.trace(m), np.linalg.norm(m)

    got, want = invariants(tq, thq.numpy(), tkeep), invariants(q, _cplx(hq),
                                                               keep)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10)


K4_D = 3 * 8 ** 3


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("addend", [None, "add", "subtract"])
@pytest.mark.parametrize("nblocks", [1, 2, 3])
def test_block_combine_plain_matches_stacked_matmul(rng, nblocks, addend,
                                                    lanes):
    """K4's plain version (``rr.combine`` on the CPU) against one
    ``torch.matmul`` over the concatenated blocks, complex128: the blocks
    slices of one (L, 48, D) stack, as in the Rayleigh-Ritz update."""
    lead = (3,) if lanes else ()
    stack = torch.as_tensor(_blk(rng, *lead, 48, K4_D))
    rows = [16, 24, 8][:nblocks]
    offs = np.cumsum([0] + rows)
    blocks = [stack[..., o:o + r, :] for o, r in zip(offs, rows)]
    coeffs = [torch.as_tensor(_blk(rng, *lead, r, 10)) for r in rows]
    want = torch.matmul(torch.cat(coeffs, -2).mT, torch.cat(blocks, -2))
    add = None
    if addend is not None:
        add = torch.as_tensor(_blk(rng, *lead, 10, K4_D))
        want = add - want if addend == "subtract" else add + want
    got = trr.combine(blocks, coeffs, add, subtract=addend == "subtract")
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ALG_TOL * float(want.abs().max()))


def test_block_combine_wrapper_refuses_what_the_kernel_cannot_take(rng):
    """The wrapper checks before it takes the plain version: a non-unit
    stride along D, another dtype, shapes past the kernel's limits; slices
    of a stacked block pass."""
    from pcx_torch.kernels import block_combine as k4
    from pcx_torch.kernels.block_combine import MAX_Q, MAX_ROWS, problem

    def c64(*s):
        return torch.as_tensor(_blk(rng, *s)).to(torch.complex64)

    stack, c = c64(2, 48, K4_D), c64(2, 48, 16)
    ok = ((stack[:, 16:], stack[:, :16]), (c[:, 16:], c[:, :16]))
    assert problem(*ok) is None
    torch.testing.assert_close(k4(*ok), c.mT @ stack, rtol=0, atol=1e-4)
    bad = [
        (((c64(16, 2 * K4_D)[:, ::2],), (c64(16, 4),)), {}, "stride"),
        (((stack.to(torch.complex128),), (c.to(torch.complex128),)), {},
         "complex64"),
        (((c64(MAX_ROWS + 1, 64),), (c64(MAX_ROWS + 1, 4),)), {}, "limits"),
        (((c64(8, 64),), (c64(8, MAX_Q + 1),)), {}, "limits"),
        (((c64(8, 64),), (c64(8, 4),)), {"addend": c64(5, 64)}, "addend"),
        (((c64(8, 64),) * 4, (c64(8, 4),) * 4), {}, "blocks"),
        (((c64(8, 64),), (c64(8, 4).conj(),)), {}, "conjugated"),
    ]
    for args, kw, why in bad:
        assert why in problem(*args, kw.get("addend"))
        with pytest.raises(ValueError, match=why):
            k4(*args, **kw)


@pytest.mark.parametrize("lanes", [False, True])
def test_block_combine_entry_args_address_the_operands(rng, lanes):
    """The integer array the C entry reads (csrc/block_combine.cu: p_b at
    5 + b, the blocks' lane and row strides at 8 + 2b, the coefficients'
    at 14 + 3b, the addend's at 23, the addend's scale's at 25) addresses
    each operand where it lies: ``as_strided`` with those strides at the
    operand's pointer gives it back."""
    from pcx_torch.kernels.block_combine import entry_args
    lead = (3,) if lanes else ()
    stack = torch.as_tensor(_blk(rng, *lead, 48, 64)).to(torch.complex64)
    coef = torch.as_tensor(_blk(rng, *lead, 48, 16)).to(torch.complex64)
    add = torch.as_tensor(_blk(rng, *lead, 16, 64)).to(torch.complex64)
    blocks = (stack[..., 16:, :], stack[..., :16, :])
    coeffs = (coef[..., 16:, :], coef[..., :16, :])
    ptrs, meta = entry_args(blocks, coeffs, add, True, add)
    assert meta[:5] == [2, 3 if lanes else 1, 16, 64, 1] and len(meta) == 27
    assert ptrs[2] == ptrs[5] == ptrs[8] == 0 and len(ptrs) == 9

    def at(base, ptr, shape, strides):
        off = base.storage_offset() + (ptr - base.data_ptr()) // 8
        return torch.as_strided(base, shape, strides, off)

    n_l = 3 if lanes else 1
    for k, (b, c) in enumerate(zip(blocks, coeffs)):
        p = meta[5 + k]
        ls, rs = meta[8 + 2 * k:10 + 2 * k]
        got = at(stack, ptrs[k], (n_l, p, 64), (ls, rs, 1))
        assert torch.equal(got.reshape(b.shape), b)
        ls, rs, cs = meta[14 + 3 * k:17 + 3 * k]
        got = at(coef, ptrs[3 + k], (n_l, p, 16), (ls, rs, cs))
        assert torch.equal(got.reshape(c.shape), c)
    got = at(add, ptrs[6], (n_l, 16, 64), (meta[23], meta[24], 1))
    assert torch.equal(got.reshape(add.shape), add)
    scale = torch.rand(*lead, 16, 2)[..., 1]     # a row stride of 2
    ptrs, meta = entry_args(blocks, coeffs, add, True, add, scale)
    off = scale.storage_offset() + (ptrs[8] - scale.data_ptr()) // 4
    got = torch.as_strided(scale, (n_l, 16), meta[25:27], off)
    assert torch.equal(got.reshape(scale.shape), scale)
    ptrs, meta = entry_args(blocks, coeffs, None, False, add)
    assert ptrs[6] == 0 and meta[4] == 0 and meta[23:] == [0, 0, 0, 0]


def test_masked_svqb_drop_two_against_blocks_equal_the_stacked_base(rng):
    """``against=(x, w)`` projects with one Gram per base and no
    concatenation: the result of the concatenated base, complex128."""
    d = K4_D
    base = np.linalg.qr(_blk(rng, d, 7))[0].T.copy()
    x, w = torch.as_tensor(base[:4]), torch.as_tensor(base[4:])
    hx, hw = torch.as_tensor(_blk(rng, 4, d)), torch.as_tensor(_blk(rng, 3, d))
    b, hb = torch.as_tensor(_blk(rng, 5, d)), torch.as_tensor(_blk(rng, 5, d))
    mask = torch.ones(5, dtype=torch.float64)
    got = trr.masked_svqb_drop(b, mask, 1e-6, hblock=hb, against=(x, w),
                               h_against=(hx, hw))
    want = trr.masked_svqb_drop(b, mask, 1e-6, hblock=hb,
                                against=(torch.cat((x, w)),),
                                h_against=(torch.cat((hx, hw)),))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0,
                                   atol=ALG_TOL * float(wnt.abs().max()))


def test_eigh_split_and_pencil_match_embeddings(rng):
    a = _blk(rng, 12, 12)
    t = a + a.conj().T
    w_j, _, _ = jrr.eigh_f64_embedding(jnp.asarray(t.real),
                                       jnp.asarray(t.imag), split=1e-10)
    w_t, v_t = trr.eigh_split(torch.as_tensor(t), 1e-10)
    scale = np.abs(t).max()
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                               atol=ALG_TOL * scale)
    np.testing.assert_allclose(
        v_t.numpy().conj().T @ v_t.numpy(), np.eye(12), atol=1e-12)
    g0 = _blk(rng, 12, 8)
    g = g0 @ g0.conj().T + 1e-3 * np.eye(12)
    th_j, _ = rs.pencil_f64_embedding(_pair(t), _pair(g))
    th_t, c_t = trr.pencil_eigh(torch.as_tensor(t), torch.as_tensor(g))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j),
                               rtol=1e-9, atol=1e-9 * np.abs(th_j).max())
    c = c_t.numpy()
    np.testing.assert_allclose(c.conj().T @ g @ c, np.eye(12), atol=1e-9)


def _pair_solvers(lattice, n, nev, jax_dtype, torch_dtype, jax_kw=None,
                  torch_opts=None, diel_type="chiral", eps_opt=0, impl="rs",
                  **kw):
    """A JAX solver (the pair-layout route, or with ``impl="complex"`` the
    complex one) and a port solver on its state.  ``kw`` (tol, maxiter,
    solver) goes to both."""
    cfg = JaxConfig(n=n, lattice=lattice, nev=nev, diel_type=diel_type,
                    eps_opt=eps_opt)
    js = JaxSolver(cfg, dtype=jax_dtype, solver_impl=impl,
                   real_boundary=True, refine=False, **(jax_kw or {}), **kw)
    # the complex route builds no device symbols: take the 1-D parts from
    # a pair-layout solver of the same config
    f = (js if impl == "rs" else
         JaxSolver(cfg, dtype=jax_dtype, solver_impl="rs",
                   real_boundary=True, refine=False))._f64
    # The JAX one-shot CPU program applies no warm cap and no doom check.
    opts = {"warm_maxiter": 0, "doom_check": False, **(torch_opts or {})}
    if diel_type == "chiral":
        diel_kw = {"scale": np.asarray(js.diel.params[0])}
    else:
        # the same dielectric as numpy (the solver's own params are in its
        # real-boundary encoding), carried across by name
        jop = jdiel.build(diel_type, n, lattice, eps_opt=eps_opt)
        diel_kw = {"diel": interop.dielectric_from(jop.name, jop.params,
                                                   jop.meta, "cpu")}
    ts = KPointSolver.from_arrays(
        ProblemConfig(n=n, lattice=lattice, nev=nev, diel_type=diel_type,
                      eps_opt=eps_opt),
        d1=f["d1"], d0=f["d0"], ct=f["ct"], device="cpu", dtype=torch_dtype,
        solver_opts=opts, **diel_kw, **kw)
    return js, ts


def _x0(ts, alpha, seed=0):
    """The plane-wave start with numpy jitter, the same for both."""
    n = ts.cfg.n
    m = ts.block_width(alpha)
    d_a = tsym.build_curl(ts.parts, alpha).numpy()
    idx, amps = tmax.plane_wave_cols(d_a, m)
    rng = np.random.default_rng(seed)
    x0 = np.zeros((m, 3, n ** 3), complex)
    x0[np.arange(m), :, idx] = amps
    shape = (m, 3, n, n, n)
    return x0.reshape(shape) + 1e-2 * (rng.random(shape)
                                       + 1j * rng.random(shape))


@pytest.mark.parametrize("lattice", ["sc_curv", "fcc", "bcc_dg"])
def test_complex128_solve_matches_pcx(lattice):
    alpha = np.array([np.pi, 0.2, 0.0])
    js, ts = _pair_solvers(lattice, 8, 4, jnp.complex128, torch.complex128)
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0))
    rt = ts.solve(alpha, x0=interop.block(x0, torch.complex128, "cpu"))
    assert rt.status == rj.status == tlob.Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= 2
    # complex128 on both sides; the small eigenproblems differ (complex
    # eigh vs real embedding with repairs), and the port validates through
    # its refine, pcx (refine=False) through Rayleigh quotients of the same
    # Ritz vectors: 1e-8 on frequencies
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious


@pytest.mark.parametrize("diel_type,eps_opt", [
    ("pseudochiral_crossdof", 3), ("pseudochiral_trivial", 2)])
def test_complex128_pseudochiral_solve_matches_pcx(diel_type, eps_opt):
    """The Hermitian-tensor dielectrics through the production solver,
    against the JAX pair-layout solver (``rs.diel_apply_p``) from the same
    start; tolerances as test_complex128_solve_matches_pcx."""
    alpha = np.array([np.pi, 0.2, 0.0])
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex128, torch.complex128,
                           diel_type=diel_type, eps_opt=eps_opt)
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0))
    rt = ts.solve(alpha, x0=interop.block(x0, torch.complex128, "cpu"))
    assert rt.status == rj.status == tlob.Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= 2
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious
    # the solver built from the config alone holds the same dielectric
    native = KPointSolver(ts.cfg, device="cpu", dtype=torch.complex128)
    assert type(native.diel) is type(ts.diel)
    for name, buf in ts.diel.named_buffers():
        assert torch.equal(buf, native.diel.get_buffer(name)), name


@pytest.mark.parametrize("solver,diel_type", [
    ("nolock", "chiral"), ("descent", "chiral"),
    ("nolock", "pseudochiral_crossdof"), ("descent", "pseudochiral_trivial")])
def test_solver_variants_match_pcx(solver, diel_type):
    """``solver="nolock"`` (every column active) and ``"descent"`` (no
    conjugate block) against the JAX pair-layout route with the same
    ``solver=``."""
    alpha = np.array([np.pi, 0.2, 0.0])
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex128, torch.complex128,
                           diel_type=diel_type, solver=solver)
    assert ts.locking is js.locking is (solver != "nolock")
    assert ts.solver_opts.get("use_p", True) is (solver != "descent")
    assert js.solver_opts.get("use_p", True) is (solver != "descent")
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0))
    rt = ts.solve(alpha, x0=interop.block(x0, torch.complex128, "cpu"))
    assert rt.status == rj.status == tlob.Status.CONVERGED
    assert abs(rt.iterations - rj.iterations) <= 2
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious
    # the variants do differ from softlock: descent needs more iterations
    if solver == "descent":
        soft = _pair_solvers("sc_curv", 8, 4, jnp.complex128,
                             torch.complex128, diel_type=diel_type)[1]
        rs_ = soft.solve(alpha, x0=interop.block(x0, torch.complex128, "cpu"))
        assert rt.iterations > rs_.iterations
        np.testing.assert_allclose(rt.omega_re, rs_.omega_re, atol=1e-6)


def test_nolock_keeps_every_column_active():
    """With locking off the tracker's active mask is all ones whatever the
    residuals and the per-column floor locks; with it on, converged columns
    drop out."""
    from pcx_torch.solvers.lobpcg_rs import _Tracker
    res = np.array([1e-9, 1.0, 1e-9, 0.5])
    lam = np.array([1.0, 2.0, 3.0, 4.0])
    args = dict(m=4, nev=2, tol=1e-4, maxiter=10, floor_patience=9,
                col_patience=3, lam_tol=0.0, lam_patience=3,
                lam_res_tol=1e-3, noise_floor=1e-12, f=np.float64)
    _, active = _Tracker(locking=True, **args).update(0, res, lam)
    assert active.tolist() == [False, True, False, True]
    _, active = _Tracker(locking=False, **args).update(0, res, lam)
    assert active.tolist() == [True] * 4


def test_eigen_1p_takes_solver_and_diel_type():
    alpha = np.array([np.pi, 0, 0])
    base = eigen_1p(8, "sc_curv", alpha, device="cpu", nev=4, verbose=False,
                    diel_type="pseudochiral_crossdof", eps_opt=1)
    res = eigen_1p(8, "sc_curv", alpha, device="cpu", nev=4, verbose=False,
                   diel_type="pseudochiral_crossdof", eps_opt=1,
                   solver="nolock")
    assert res.status == base.status == tlob.Status.CONVERGED
    assert not res.report.spurious
    np.testing.assert_allclose(res.omega_re, base.omega_re, atol=1e-6)
    # the Hermitian-tensor dielectric moves the bands off the chiral ones
    chiral = eigen_1p(8, "sc_curv", alpha, device="cpu", nev=4,
                      verbose=False)
    assert np.abs(chiral.omega_re - base.omega_re).max() > 1e-2


def test_complex128_rr_gram_pallas_solve_matches_pcx():
    """rr_gram="pallas": the Gram of K3 (plain version here; complex64
    operands, f32 chunk partials summed in f64) and the blockwise update,
    against the JAX solver with the same option (Pallas interpret mode)."""
    alpha = np.array([np.pi, 0.2, 0.0])
    opts = {"rr_gram": "pallas"}
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex128, torch.complex128,
                           jax_kw={"solver_opts": dict(opts)},
                           torch_opts=opts)
    assert ts.solver_opts == opts
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0))
    rt = ts.solve(alpha, x0=interop.block(x0, torch.complex128, "cpu"))
    assert rt.status == rj.status
    assert rt.status in (1, 5)
    assert abs(rt.iterations - rj.iterations) <= 2
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=1e-8)
    assert not rt.report.spurious


def test_complex64_solve_plain_kernels_match_pallas_interpret_k3():
    """complex64 with all three kernels' plain versions (K1, K2 and, with
    rr_gram="pallas", K3) against the three Pallas kernels in interpret
    mode."""
    alpha = np.array([np.pi, 0.0, 0.0])
    kw = dict(tol=1e-5, maxiter=300)
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex64, torch.complex64,
                           jax_kw={"solver_opts": {"rp_fuse": "pallas",
                                                   "dft_fuse": "pallas",
                                                   "rr_gram": "pallas"}},
                           torch_opts={"rr_gram": "pallas"}, **kw)
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0.astype(np.complex64)))
    rt = ts.solve(alpha, x0=torch.as_tensor(x0))
    assert rt.status in (1, 5) and rj.status in (1, 5)
    # complex64 iterates: frequencies to 5e-5 (tests/test_pallas.py:160)
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=5e-5)


def test_complex64_crossdof_solve_plain_kernels_match_pallas_interpret():
    """The cross-DoF dielectric in complex64 with all three kernels' plain
    versions against the three Pallas kernels in interpret mode."""
    alpha = np.array([np.pi, 0.0, 0.0])
    kw = dict(tol=1e-5, maxiter=300)
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex64, torch.complex64,
                           jax_kw={"solver_opts": {"rp_fuse": "pallas",
                                                   "dft_fuse": "pallas",
                                                   "rr_gram": "pallas"}},
                           torch_opts={"rr_gram": "pallas"},
                           diel_type="pseudochiral_crossdof", **kw)
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0.astype(np.complex64)))
    rt = ts.solve(alpha, x0=torch.as_tensor(x0))
    assert rt.x.dtype == torch.complex64
    assert rt.status in (1, 5) and rj.status in (1, 5)
    # complex64 iterates: frequencies to 5e-5 (tests/test_pallas.py:160)
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=5e-5)


def test_one_solver_opts_dict_drives_both_packages():
    """The JAX KPointSolver pops warm_maxiter, doom_check and doom_tol from
    solver_opts (pcx/bandstructure.py:238, 255-257); the port takes the
    same dict and pops the same keys."""
    opts = {"warm_maxiter": 40, "doom_check": False, "doom_tol": 2e-3,
            "lam_res_tol": 5e-4, "rr_gram": "pallas"}
    js = JaxSolver(JaxConfig(n=8, lattice="sc_curv", nev=4),
                   dtype=jnp.complex128, solver_opts=dict(opts))
    ts = KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                      device="cpu", dtype=torch.complex128,
                      solver_opts=dict(opts))
    for name in ("warm_maxiter", "doom_check", "doom_tol"):
        assert getattr(ts, name) == getattr(js, name) == opts[name]
        assert name not in ts.solver_opts and name not in js.solver_opts
    assert ts.solver_opts == {"lam_res_tol": 5e-4, "rr_gram": "pallas"}
    # doom_tol defaults to lam_res_tol, else 1e-3, in both packages
    for extra, want in (({"lam_res_tol": 5e-4}, 5e-4), ({}, 1e-3)):
        js = JaxSolver(JaxConfig(n=8, lattice="sc_curv", nev=4),
                       dtype=jnp.complex128, solver_opts=dict(extra))
        ts = KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                          device="cpu", dtype=torch.complex128,
                          solver_opts=dict(extra))
        assert ts.doom_tol == js.doom_tol == want
        assert ts.warm_maxiter == js.warm_maxiter == 150
        assert ts.doom_check is js.doom_check is True


def test_complex64_solve_plain_kernels_match_pallas_interpret():
    alpha = np.array([np.pi, 0.0, 0.0])
    kw = dict(tol=1e-5, maxiter=300)
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex64, torch.complex64,
                           jax_kw={"solver_opts": {"rp_fuse": "pallas",
                                                   "dft_fuse": "pallas"}},
                           **kw)
    assert ts.solver_opts == {"ortho_passes": 2, "refresh_every": 8,
                              "floor_patience": 6}
    x0 = _x0(ts, alpha)
    rj = js.solve(alpha, x0=boundary.encode(x0.astype(np.complex64)))
    rt = ts.solve(alpha, x0=torch.as_tensor(x0))
    assert rt.status in (1, 5) and rj.status in (1, 5)
    # complex64 iterates: frequencies to 5e-5 (tests/test_pallas.py:160)
    np.testing.assert_allclose(rt.omega_re, rj.omega_re, atol=5e-5)


def test_refine_matches_pcx_f64_refine():
    """The complex128 refine (torch.fft, complex eigh pencil) reproduces the
    JAX emulated-f64 refine of the same complex64 block."""
    alpha = np.array([np.pi, 0.1, 0.0])
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex64, torch.complex64,
                           tol=1e-5)
    js.refine = True
    r = ts.solve(alpha, validate_result=False)
    x = r.x.numpy()
    rep_j, theta_j, _ = js._refine_report(alpha, boundary.encode(x))
    theta_t, lam_re_t, res_t = ts.refine_stats(alpha, r.x)
    np.testing.assert_allclose(theta_t, np.asarray(theta_j), rtol=1e-10)
    rep_t = ts.validate_solution(alpha, r)
    np.testing.assert_allclose(rep_t.omega_re, rep_j.omega_re, atol=1e-10)
    np.testing.assert_allclose(rep_t.omega_pnt, rep_j.omega_pnt, atol=1e-10)
    np.testing.assert_allclose(rep_t.residuals, rep_j.residuals, rtol=1e-6,
                               atol=1e-10)
    assert not rep_t.spurious and not rep_j.spurious


@pytest.mark.parametrize("diel_type", ["pseudochiral_crossdof",
                                       "pseudochiral_trivial"])
def test_refine_pseudochiral_matches_pcx_f64_refine(diel_type):
    """The complex128 refine applies the double-precision form of a
    Hermitian-tensor dielectric; against the JAX f64 refine of the same
    complex64 block.  The JAX complex64 solver stores the eps^{-1} entries
    in float32 and casts them up (preset 0 holds sqrt(1 + 0.875^2) / 13,
    not a float32 number), the port holds doubles: theta agrees to the
    float32 rounding of those entries, 2e-7 relative."""
    alpha = np.array([np.pi, 0.1, 0.0])
    js, ts = _pair_solvers("sc_curv", 8, 4, jnp.complex64, torch.complex64,
                           diel_type=diel_type, tol=1e-5)
    js.refine = True
    r = ts.solve(alpha, validate_result=False)
    rep_j, theta_j, _ = js._refine_report(alpha, boundary.encode(r.x.numpy()))
    theta_t, _, _ = ts.refine_stats(alpha, r.x)
    np.testing.assert_allclose(theta_t, np.asarray(theta_j), rtol=2e-7)
    rep_t = ts.validate_solution(alpha, r)
    np.testing.assert_allclose(rep_t.omega_re, rep_j.omega_re, atol=1e-7)
    np.testing.assert_allclose(rep_t.omega_pnt, rep_j.omega_pnt, atol=1e-7)
    assert not rep_t.spurious and not rep_j.spurious


@pytest.mark.parametrize("case", ["clean", "spurious", "nan", "gamma"])
def test_recompute_matches_pcx(case):
    lam = np.array([2.8, 3.1, 4.9, 5.0])
    lam_re = lam - np.array([1e-9, 2e-9, 0.0, 1e-9])
    res = np.array([1e-5, 2e-5, 3e-5, 4e-5])
    shift = 0.0
    if case == "spurious":
        lam_re[2] += 0.5
    elif case == "nan":
        lam_re[1] = np.nan
        lam[3] = np.nan
    elif case == "gamma":
        shift = 1.0 / np.pi
        lam = lam + shift
    kw = dict(shift=shift, scal=1.0, raise_on_spurious=False)
    want = jval.recompute(lam, stats=(lam_re, res), **kw)
    got = tval.recompute(lam, stats=(lam_re, res), **kw)
    np.testing.assert_array_equal(got.omega_pnt, want.omega_pnt)
    np.testing.assert_array_equal(got.omega_re, want.omega_re)
    np.testing.assert_array_equal(got.residuals, want.residuals)
    assert got.spurious == want.spurious == (case in ("spurious", "nan"))
    assert got.table() == want.table()


def test_status_codes_and_spurious_gate_match_pcx():
    """Later PRs must not drift from the JAX package's status values, result
    fields or the 1e-3 spurious gate (non-finite counts as spurious,
    pcx/validate.py:90-92)."""
    assert ({s.name: int(s) for s in tlob.Status}
            == {s.name: int(s) for s in jlob.Status})
    assert tlob.SolveResult._fields == jlob.SolveResult._fields
    lam = np.array([(2 * np.pi * 0.4) ** 2])
    for d_omega, spurious in ((0.9e-3, False), (1.1e-3, True)):
        lam_re = np.array([(2 * np.pi * (0.4 + d_omega)) ** 2])
        for mod in (tval, jval):
            rep = mod.recompute(lam, stats=(lam_re, [0.0]),
                                raise_on_spurious=False)
            assert rep.spurious is spurious
    for bad in (np.inf, np.nan):
        assert tval.recompute([bad], stats=([1.0], [0.0]),
                              raise_on_spurious=False).spurious
    with pytest.raises(tval.SpuriousModeError):
        tval.recompute(lam, stats=(lam * 1.1, [0.0]))
    assert issubclass(tval.SpuriousModeError, RuntimeError)


def test_eigen_1p_converges_without_spurious_modes():
    res = eigen_1p(8, "sc_curv", np.array([np.pi, 0, 0]), device="cpu",
                   nev=4, verbose=False)
    assert res.status == tlob.Status.CONVERGED
    assert not res.report.spurious
    np.testing.assert_allclose(res.omega, res.omega_re, atol=1e-8)
    assert res.x.shape == (6, 3, 8, 8, 8)


def test_warm_maxiter_caps_warm_solves_only():
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    solver = KPointSolver(cfg, device="cpu", dtype=torch.complex128,
                          solver_opts={"warm_maxiter": 8})
    alpha = np.array([np.pi, 0, 0])
    cold = solver.solve(alpha, seed=1, validate_result=False)
    assert cold.iterations > 8
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(cold.x.shape, generator=gen, dtype=torch.complex128)
    warm = solver.solve(alpha, x0=x0, validate_result=False)
    assert warm.iterations <= 8 and warm.status == tlob.Status.MAXITER


def test_solver_rejects_unknown_options_and_dielectrics():
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    with pytest.raises(ValueError, match="rr_mirror"):
        KPointSolver(cfg, device="cpu", dtype=torch.complex128,
                     solver_opts={"rr_mirror": True})
    with pytest.raises(ValueError, match="unknown rr_gram 'xla9'"):
        KPointSolver(cfg, device="cpu", dtype=torch.complex128,
                     solver_opts={"rr_gram": "xla9"}).solve(
                         np.array([np.pi, 0, 0]))
    with pytest.raises(KeyError, match="Unknown dielectric type"):
        KPointSolver(ProblemConfig(n=8, diel_type="pseudochiral_nope"),
                     device="cpu", dtype=torch.complex128)
    for name in ("softlock", "nolock", "mixed", "descent", "davidson", "jd"):
        ts = KPointSolver(cfg, device="cpu", dtype=torch.complex128,
                          solver=name)
        assert ts.solver == name
        JaxSolver(JaxConfig(n=8, lattice="sc_curv", nev=4), solver=name)
    with pytest.raises(ValueError, match="unknown solver 'hardlock'"):
        KPointSolver(cfg, device="cpu", dtype=torch.complex128,
                     solver="hardlock")
    with pytest.raises(ValueError, match="unknown solver 'hardlock'"):
        JaxSolver(JaxConfig(n=8, lattice="sc_curv", nev=4),
                  solver="hardlock")
    with pytest.raises(ValueError, match="exactly one of scale= and diel="):
        KPointSolver.from_arrays(cfg, d1=None, d0=None, ct=None,
                                 device="cpu", dtype=torch.complex128)
    with pytest.raises(ValueError, match="unknown solver"):
        eigen_1p(8, "sc_curv", np.array([np.pi, 0, 0]), device="cpu",
                 solver="hardlock")


@pytest.mark.parametrize("opts", [{"col_patience": 3, "floor_patience": 3},
                                  {"lam_tol": 1e-9},
                                  {"refresh_every": 3, "ortho_passes": 1}])
def test_solver_levers_preserve_frequencies(opts):
    """The termination / cost levers change when the solve stops, not what
    it converges to (tests/test_bandstructure.py::
    test_solver_lever_opts_preserve_frequencies)."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.3, 0.0])
    kw = dict(device="cpu", dtype=torch.complex128)
    base = KPointSolver(cfg, **kw).solve(alpha, seed=3)
    r = KPointSolver(cfg, solver_opts=dict(opts), **kw).solve(alpha, seed=3)
    assert r.status in (1, 5)
    np.testing.assert_allclose(r.omega_re, base.omega_re, atol=5e-6)


def test_interop_dft_and_block_match_pcx():
    from pcx.operators import dft as jdft
    from pcx_torch.operators.dft import dft_mats
    w = jdft.dft_mats(10, np.complex128)
    got = interop.dft((np.asarray(w.fwd.real), np.asarray(w.fwd.imag)), w.inv,
                      torch.complex64, "cpu")
    want = dft_mats(10, torch.complex64, "cpu")
    assert torch.equal(got.fwd, want.fwd) and torch.equal(got.inv, want.inv)
    x = np.arange(6.0).reshape(2, 3) + 1j
    assert torch.equal(interop.block((x.real, x.imag), torch.complex128, "cpu"),
                       torch.as_tensor(x))
