"""Process groups for the two parallel axes of the workload (port of
``pcx/parallel/mesh.py`` on ``torch.distributed``):

* "k"    — the Brillouin-zone sweep: k-points are independent solves
           (the reference's serial loop, numerical_experiments.py:418);
* "grid" — the FFT grid for N beyond one card's memory: the pencil 3-D FFT
           and local symbol multiplies, with every Gram all-reduced.

PyTorch runs one process per card, where JAX runs one controller over every
device.  A mesh here is a ``DeviceMesh`` with dims ("k", "grid") over the
initialized default process group, rank-major: rank r sits at
(r // n_grid, r % n_grid), so the ranks of one grid group are consecutive
and, under torchrun, on one host.  Each process already holds its own
shard, so JAX's ``shard_map`` and its PartitionSpecs (``field_spec``,
``symbol_spec``) have no counterpart: in their place ``local_shard`` cuts
this rank's contiguous slice of a full tensor along an axis and
``gather_shards`` joins the slices of a group back into the full tensor.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

K_AXIS = "k"
GRID_AXIS = "grid"

# A rank that waits longer than this in a collective fails instead of
# hanging: the ranks of a diverged solve take different branches.
TIMEOUT = datetime.timedelta(minutes=10)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def make_mesh(n_k: Optional[int] = None, n_grid: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh over ("k", "grid") of the initialized process group.  Defaults
    as in JAX: all grid if only n_grid is given, else every rank on the k
    axis (independent solves scale perfectly; grid sharding pays two
    all-to-alls per operator apply)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed)")
    n_dev = dist.get_world_size()
    if n_k is None and n_grid is None:
        n_k, n_grid = n_dev, 1
    elif n_k is None:
        n_k = n_dev // n_grid
    elif n_grid is None:
        n_grid = n_dev // n_k
    if n_k * n_grid != n_dev:
        raise ValueError(f"mesh {n_k}x{n_grid} != {n_dev} ranks")
    return init_device_mesh(device_type, (n_k, n_grid),
                            mesh_dim_names=(K_AXIS, GRID_AXIS))


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device_type: str = "cuda",
                     timeout: datetime.timedelta = TIMEOUT) -> int:
    """Join the process group of a multi-card run; returns this rank.

    The arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the ``env://`` rendezvous), ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK``.  ``init_method`` may instead name a ``file://`` or
    ``tcp://localhost:<port>`` rendezvous.  With neither arguments nor
    variables this is a no-op that returns 0, as in JAX.

    ``device_type="cuda"`` joins over NCCL and binds the process to card
    ``LOCAL_RANK``; ``"cpu"`` joins over gloo.  Without a card a CUDA
    run raises: it never falls back to gloo.  ``timeout`` bounds every
    collective, so that a rank whose partners diverged fails instead of
    hanging.
    """
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and world_size is None:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type {device_type!r}")
    kw = {}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device_type='cuda'): no "
                               "CUDA device; pass device_type='cpu' for "
                               "gloo")
        local = int(env.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    return dist.get_rank()


def make_multihost_mesh(n_grid: int = 1,
                        device_type: str = "cuda") -> DeviceMesh:
    """Mesh after :func:`init_distributed` with the k axis across hosts
    (k-point solves never communicate) and each grid group inside one host
    (``LOCAL_WORLD_SIZE`` cards), where the all-to-alls of every operator
    apply stay on NVLink.  torchrun numbers the ranks host by host, so the
    rank-major mesh keeps a grid group on one host when ``n_grid`` is at
    most the cards per host; a larger ``n_grid`` raises, as in JAX."""
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if n_grid > max(n_local, 1):
        raise ValueError(f"n_grid={n_grid} exceeds {n_local} cards per host "
                         f"— grid all-to-alls would cross hosts")
    return make_mesh(n_grid=n_grid, device_type=device_type)


def host_slice(n_items: int) -> list:
    """The work items of this process, strided by rank: the multi-host
    split of the band sweep."""
    if not dist.is_initialized():
        return list(range(n_items))
    return list(range(dist.get_rank(), n_items, dist.get_world_size()))


def local_shard(x: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """This rank's contiguous slice of the full tensor ``x`` along ``axis``
    over ``group`` (the place of a PartitionSpec in JAX's ``shard_map``).
    The axis must divide evenly."""
    g, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[axis]
    if size % g:
        raise ValueError(f"axis {axis} of extent {size} does not split "
                         f"over {g} ranks")
    s = size // g
    return x.narrow(axis, r * s, s).contiguous()


def gather_shards(x_local: torch.Tensor, axis: int,
                  group=None) -> torch.Tensor:
    """The full tensor from every rank's ``local_shard`` along ``axis``
    (on every rank of ``group``)."""
    x_local = x_local.contiguous()
    parts = [torch.empty_like(x_local)
             for _ in range(dist.get_world_size(group))]

    def real(t):
        return torch.view_as_real(t) if t.is_complex() else t

    dist.all_gather([real(p) for p in parts], real(x_local), group=group)
    return torch.cat(parts, dim=axis)
