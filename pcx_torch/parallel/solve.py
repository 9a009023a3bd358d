"""Grid-sharded Maxwell LOBPCG: one k-point solve spread over the ranks of
the mesh's "grid" group, for an N whose blocks one card cannot hold (port
of ``pcx/parallel/solve.py``).

The (m, 3, Nx, Ny, Nz) Fourier-space block is sharded on its LAST grid axis;
each operator application is

    a_block(-conj D_A)          local   (z-sharded symbols)
    pencil fftn                 1 all-to-all (-> x-sharded)
    eps^{-1}                    local   (x-sharded dielectric arrays; the
                                cross-DoF stencils along x roll through
                                halo exchanges)
    pencil ifftn                1 all-to-all (-> z-sharded)
    a_block(D_A) + penalty      local

and every Gram and norm inside ``lobpcg_sep`` is all-reduced over the group
(``reduce_axis``).  As in JAX this path runs no hand-written kernel: the
transforms are torch.fft, the solver the complex ``lobpcg_sep``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from pcx_torch.config import MAXITER, TOL
from pcx_torch.operators.blocks import a_block, h_block
from pcx_torch.operators.dielectric import _AX_I, make_crossdof_apply
from pcx_torch.parallel.fft import pencil_fftn, pencil_ifftn, sharded_roll
from pcx_torch.parallel.mesh import GRID_AXIS, local_shard
from pcx_torch.solvers.lobpcg import SolveResult, lobpcg_sep
from pcx_torch.utils import real_dtype


def make_sharded_crossdof(diag, masks, sten, eps3, eps4, eps5, group=None):
    """Cross-DoF eps^{-1} apply in the pencil (x-sharded) layout: the
    averaging stencils along the sharded x axis roll through
    ``sharded_roll`` (one k-plane halo per offset), the y and z stencils
    stay local.  ``diag`` and ``masks`` are this rank's x-shards, real, in
    the field's real dtype."""
    n_shards = dist.get_world_size(group)

    def roll_fn(v, shift, axis):
        if axis % v.dim() == _AX_I % v.dim() and n_shards > 1:
            return sharded_roll(v, shift, axis, group)
        return torch.roll(v, shift, axis)

    apply = make_crossdof_apply(sten, eps3, eps4, eps5, roll_fn)
    return lambda x: apply((diag, masks), x)


def sharded_ama_bb(x, d_a, b, diel_apply, shift, group=None):
    """The penalized operator A M A^H + B^H B + shift on a z-sharded local
    block; ``diel_apply`` acts in the x-sharded layout between the pencil
    FFTs: a pointwise scale array or any local callable (``h_block`` of a
    Hermitian tensor, the sharded cross-DoF apply)."""
    y = a_block(x, -d_a.conj())
    y = pencil_fftn(y, group)
    y = diel_apply(y) if callable(diel_apply) else y * diel_apply
    y = pencil_ifftn(y, group)
    y = a_block(y, d_a)
    y = y + h_block(x, b)
    return y + shift * x


def solve_kpoint_sharded(mesh, d_a, b: Tuple, inv: Tuple, scale, shift: float,
                         x0: torch.Tensor, nev: int, tol: float = TOL,
                         maxiter: int = MAXITER, **solver_kw) -> SolveResult:
    """One grid-sharded LOBPCG solve over the mesh's "grid" group.

    Every rank passes the FULL arrays, as JAX's caller does; each cuts its
    own slices (``local_shard``): the symbols ``d_a`` (3, N, N, N), ``b``
    and ``inv`` (diag, sdiag) pairs and the start block ``x0`` (m, 3, N, N,
    N) along z, the dielectric along x.  ``scale`` is one of

    * the pointwise eps^{-1} array (3, N, N, N) (chiral, smooth);
    * a (diag, sdiag) pair: the pseudochiral-trivial Hermitian tensor;
    * ``{"crossdof": (diag, masks, sten, eps3, eps4, eps5)}``: the cross-DoF
      averaging dielectric, its x stencils through halo rolls.

    The solve runs on the mesh's device in the dtype of ``x0`` with
    ``rr_mode="f64"`` unless ``solver_kw`` says otherwise.  The result's
    ``x`` is THIS RANK'S z-shard (m, 3, N, N, N/g), not the whole field:
    the grid axis exists for an N whose block one card cannot hold.
    ``gather_shards(res.x, -1, group)`` rebuilds the whole field where it
    is needed.  Every rank returns the same lambdas, iterations, status
    and history.
    """
    group = mesh.get_group(GRID_AXIS)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    cdtype = torch.as_tensor(x0).dtype
    rdtype = real_dtype(cdtype)

    def z_cut(a, dtype=cdtype):
        return local_shard(torch.as_tensor(a), -1, group).to(dev, dtype)

    def x_cut(a, dtype):
        return local_shard(torch.as_tensor(a), -3, group).to(dev, dtype)

    if isinstance(scale, dict) and "crossdof" in scale:
        diag, masks, sten, e3, e4, e5 = scale["crossdof"]
        diel = make_sharded_crossdof(x_cut(diag, rdtype),
                                     x_cut(masks, rdtype), sten, e3, e4, e5,
                                     group)
    elif isinstance(scale, (tuple, list)):
        herm = (x_cut(scale[0], rdtype), x_cut(scale[1], cdtype))

        def diel(v):
            return h_block(v, herm)
    else:
        diel = x_cut(scale, rdtype)
    d_a_l = z_cut(d_a)
    b_l = (z_cut(b[0], rdtype), z_cut(b[1]))
    inv_l = (z_cut(inv[0], rdtype), z_cut(inv[1]))

    def h_func(v):
        return sharded_ama_bb(v, d_a_l, b_l, diel, shift, group)

    def p_func(v):
        return h_block(v, inv_l)

    solver_kw.setdefault("rr_mode", "f64")
    return lobpcg_sep(h_func, p_func, z_cut(x0), nev, tol=tol,
                      maxiter=maxiter, reduce_axis=group, **solver_kw)
