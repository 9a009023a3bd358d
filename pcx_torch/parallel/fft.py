"""Pencil-decomposed distributed 3-D FFT and the halo roll over a process
group (port of ``pcx/parallel/fft.py``).

A field (..., Nx, Ny, Nz) is sharded over its LAST axis; the transform runs

    fft over (x, y) locally
    all-to-all over the group: z-split -> x-split
    fft over z locally

so each 3-D FFT costs one all-to-all each way, and the inverse returns the
input's layout.  ``all_to_all_single`` splits and joins dim 0, where JAX's
``all_to_all(split_axis=x, concat_axis=z, tiled=True)`` names the axes: the
x axis is cut into (g, Nx/g) and g moved to the front before the exchange,
and the chunks received, one per rank in rank order, are put back along z.
Complex tensors travel as their real views.  torch.fft (cuFFT on the card)
transforms, as ``jnp.fft`` does in JAX: no Pallas kernel runs here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _exchange(y: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of the contiguous (g, ...) ``y``: chunk s goes to rank s,
    and chunk s of the result came from rank s."""
    out = torch.empty_like(y)
    dist.all_to_all_single(_real(out), _real(y), group=group)
    return out


def pencil_fftn(x: torch.Tensor, group=None) -> torch.Tensor:
    """Forward 3-D FFT of a z-sharded block.

    Input:  local shard (..., Nx, Ny, Nz/g), z-sharded.
    Output: local shard (..., Nx/g, Ny, Nz), x-sharded (pencil-transposed).
    """
    g = dist.get_world_size(group)
    x = torch.fft.fftn(x, dim=(-3, -2))
    *lead, nx, ny, nzl = x.shape
    if nx % g:
        raise ValueError(f"Nx={nx} does not split over {g} ranks")
    y = x.reshape(*lead, g, nx // g, ny, nzl).movedim(len(lead), 0)
    y = _exchange(y.contiguous(), group)      # y[s]: my x slab, z chunk s
    y = y.movedim(0, -2).reshape(*lead, nx // g, ny, g * nzl)
    return torch.fft.fft(y, dim=-1)


def pencil_ifftn(x: torch.Tensor, group=None) -> torch.Tensor:
    """Inverse of :func:`pencil_fftn`: x-sharded in, z-sharded out."""
    g = dist.get_world_size(group)
    x = torch.fft.ifft(x, dim=-1)
    *lead, nxl, ny, nz = x.shape
    if nz % g:
        raise ValueError(f"Nz={nz} does not split over {g} ranks")
    y = x.reshape(*lead, nxl, ny, g, nz // g).movedim(-2, 0)
    y = _exchange(y.contiguous(), group)      # y[s]: x slab s, my z chunk
    y = y.movedim(0, len(lead)).reshape(*lead, g * nxl, ny, nz // g)
    return torch.fft.ifftn(y, dim=(-3, -2))


def _permute(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``t`` to group rank ``dst`` and return what group rank ``src``
    sent (JAX's ``ppermute`` for one ring shift)."""
    grp = group if group is not None else dist.group.WORLD
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, _real(t), dist.get_global_rank(grp, dst),
                      group),
           dist.P2POp(dist.irecv, _real(out),
                      dist.get_global_rank(grp, src), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def sharded_roll(x: torch.Tensor, shift: int, axis: int,
                 group=None) -> torch.Tensor:
    """Circular roll of a tensor whose ``axis`` is sharded contiguously over
    ``group``: ``torch.roll`` of the full tensor, cut the same way.

    The shift decomposes as q whole shards plus r < local-extent planes: the
    block moves q ranks along the ring, then the last r planes of each rank
    go to its right neighbour, whose output starts with them.  Any shift,
    also beyond the local extent, works.  Used by the cross-DoF dielectric
    stencils along the sharded axis (a k-plane halo for a 2k-wide stencil).
    """
    g = dist.get_world_size(group)
    if shift == 0 or g == 1:
        return torch.roll(x, shift, axis)
    ax = axis % x.dim()
    nloc = x.shape[ax]
    q, r = divmod(shift, nloc)
    q %= g
    me = dist.get_rank(group)
    if q:
        x = _permute(x, (me + q) % g, (me - q) % g, group)
    if r == 0:
        return x
    recv = _permute(x.narrow(ax, nloc - r, r), (me + 1) % g, (me - 1) % g,
                    group)
    return torch.cat((recv, x.narrow(ax, 0, nloc - r)), dim=ax)
