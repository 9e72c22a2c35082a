"""Mesh construction and canonical placements.

Port of ``spatialcore_tpu/parallel/mesh.py``. Axes: ``cells`` (the cell
dimension) × ``genes`` (the gene / permutation dimension) of a
``torch.distributed`` ``DeviceMesh``, one rank a device. On one rank every
placement degenerates to replication, so the same code runs everywhere.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("cells", "genes")


def _ensure_group(device: Optional[str]) -> str:
    """The mesh's device type; with no process group, make a one-rank group
    (NCCL on the card, gloo on the CPU) through an in-memory store, so a
    plain script needs no environment variables or port."""
    if dist.is_initialized():
        if device is not None:
            return device
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    device = device or "cuda"
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return device


def auto_mesh(n_devices: Optional[int] = None,
              cell_shards: Optional[int] = None,
              devices: Optional[Sequence[int]] = None,
              device: Optional[str] = None):
    """A (cells × genes) ``DeviceMesh`` over the process group's ranks.

    By default every rank goes on ``genes``: permutation nulls over genes
    need no communication, and the fixed-degree graph stays whole on each
    rank. ``cell_shards`` splits the cell axis instead (when N is too large
    for one device). ``devices`` lists the ranks to use (default: all);
    ``n_devices`` keeps the first n of them. Every rank of the group must
    call this.

    Multi-host (``LOCAL_WORLD_SIZE`` ranks a host, as ``torchrun`` sets):
    the host dimension folds into ``cells``, so cross-host traffic is the
    cell axis' one-time gathers and reductions, while the gene axis stays
    inside each host.

    ``device``: "cuda" or "cpu"; None follows the process group's backend
    (NCCL: "cuda"), or "cuda" when this call makes the group itself.
    """
    from torch.distributed.device_mesh import DeviceMesh

    device = _ensure_group(device)
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_hosts = max(world // max(n_local, 1), 1)
    if devices is None and n_hosts > 1:
        cs = cell_shards or n_hosts
        if cs % n_hosts != 0:
            raise ValueError(
                f"cell_shards={cs} must be a multiple of the host count "
                f"{n_hosts} (the host dimension folds into the cells axis)")
        per_host_cells = cs // n_hosts
        if n_local % per_host_cells != 0:
            raise ValueError(
                f"cell_shards={cs} does not tile {n_hosts} hosts × "
                f"{n_local} local devices")
        # ranks are host-major, so host h's rows are h·(cs/hosts) onwards
        return DeviceMesh(device, torch.arange(world).reshape(cs, -1),
                          mesh_dim_names=AXES)
    ranks = list(devices if devices is not None else range(world))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    n = len(ranks)
    cs = cell_shards or 1
    if n % cs != 0:
        raise ValueError(f"cell_shards={cs} does not divide {n} devices")
    return DeviceMesh(device, torch.tensor(ranks).reshape(cs, n // cs),
                      mesh_dim_names=AXES)


def _placements(mesh, dims: Tuple[Optional[int], ...]):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if d is None else Shard(d) for d in dims)


def gene_sharding(mesh, ndim: int = 2):
    """[..., genes]-last placement: the trailing gene axis split over
    ``genes``, replicated over ``cells``."""
    return _placements(mesh, (None, ndim - 1))


def cell_sharding(mesh, ndim: int = 2):
    """[cells, ...] placement: the leading cell axis split over ``cells``."""
    del ndim
    return _placements(mesh, (0, None))


def replicated(mesh):
    """Every rank holds the whole tensor."""
    return _placements(mesh, (None, None))
