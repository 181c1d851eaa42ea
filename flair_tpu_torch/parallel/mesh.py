"""Device mesh and sharding helpers over ``torch.distributed``.

Counterpart of ``flair_tpu/parallel/mesh.py``. JAX places one global array
on a ``Mesh`` with a ``NamedSharding``; here the convention is that every
rank is called with the same host inputs, keeps its own shard, and gets the
whole result back:

- ``make_mesh`` builds a ``DeviceMesh`` over the initialised default group,
  one process group per row of each axis, each created with
  ``GROUP_TIMEOUT`` so that a rank that stops makes the others raise
  instead of hang. Its device type is ``cuda`` under NCCL and ``cpu`` under
  gloo: gloo ranks may share one card (all on ``cuda:0``, CUDA tensors
  staged through the host), and building the mesh touches no device.
  Tensors stay on the callers' ``device=``.
- ``batch_sharding`` / ``shard_batch``: dim 0 cut by the rank's ``data``
  coordinate, dim 1 by its ``frame`` coordinate.
- ``replicate_params``: the mesh's first rank's parameters broadcast to
  every rank, in place (the reference's rank-0 broadcast,
  dist_util.py:40-79).
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .collectives import broadcast_from_first_

GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data", "frame"),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over every rank of the default group. Default layout: all
    ranks on ``data``, 1 on every other axis; pass ``shape`` to split, e.g.
    shape=(2, 2) for 2-way data × 2-way frame. ``n_devices`` must be the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh spans the whole world: n_devices={n}, "
                         f"world size {world}")
    axes = tuple(axes)
    shape = (n,) + (1,) * (len(axes) - 1) if shape is None else shape
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes} "
                         f"over {n} ranks")
    ranks = torch.arange(n).reshape(shape)
    groups = []
    for dim, size in enumerate(shape):
        mine = None
        for line in ranks.movedim(dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(line, timeout=GROUP_TIMEOUT)
            if dist.get_rank() in line:
                mine = group
        groups.append(mine)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh.from_group(groups, device_type, mesh=ranks,
                                 mesh_dim_names=axes)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def is_first_rank(mesh: DeviceMesh) -> bool:
    """Whether this process is the mesh's first rank (the one that writes
    checkpoints and logs)."""
    return dist.get_rank() == int(mesh.mesh.reshape(-1)[0])


def batch_sharding(mesh: DeviceMesh, ndim: int = 5) -> tuple:
    """((dim, axis), ...) of a (B, T, ...) tensor: B over ``data``, T over
    ``frame``, for the axes the mesh has."""
    names = mesh.mesh_dim_names
    rules = [(0, "data")] if "data" in names else []
    if "frame" in names and ndim > 1:
        rules.append((1, "frame"))
    return tuple(rules)


def replicated(mesh: DeviceMesh) -> tuple:
    """The rule that cuts nothing: every rank holds the whole tensor."""
    return ()


def shard(x, mesh: DeviceMesh, rules):
    """This rank's slice of ``x`` (a tensor or numpy array) under
    ``rules`` ((dim, axis), ...); each cut dim must divide evenly."""
    for dim, axis in rules:
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways over '{axis}'")
        size = x.shape[dim] // n
        lo = mesh.get_local_rank(axis) * size
        x = x[(slice(None),) * dim + (slice(lo, lo + size),)]
    return x


def shard_batch(mesh: DeviceMesh, batch):
    """This rank's slice of each (B, T, ...) tensor of a dict / list /
    tuple (or of one tensor)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return shard(batch, mesh, batch_sharding(mesh, batch.ndim))


def replicate_params(mesh: DeviceMesh, params):
    """Every rank's parameters (a module's parameters and buffers, a dict
    or a list of tensors) set to the mesh's first rank's, in place.
    Returns ``params``."""
    if isinstance(params, torch.nn.Module):
        tensors = list(params.parameters()) + list(params.buffers())
    elif isinstance(params, dict):
        tensors = list(params.values())
    else:
        tensors = list(params)
    broadcast_from_first_([t.data for t in tensors], mesh)
    return params
