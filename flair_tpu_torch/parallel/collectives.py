"""Differentiable collectives over a process group.

No counterpart in ``flair_tpu/parallel``: there GSPMD and shard_map insert
the collectives and ``jax.grad`` differentiates them. Here they are
``autograd.Function``s with their adjoints written out:

- ``all_gather_frames``: forward all-gather + concatenate along ``dim``;
  backward all-reduce (sum) of the incoming gradient, then this rank's
  chunk (the reduce-scatter that is all-gather's adjoint; gloo has no
  reduce_scatter). ``torch.distributed.nn.functional.all_gather`` is not
  used: its backward scatters with group-local source ranks and fails on a
  sub-group.
- ``all_reduce_mean``: forward and backward are the same all-reduce mean.

Both adjoints assume that the ranks' losses SUM to the loss being
differentiated, each rank's loss covering its own share (``train.loop``
divides each rank's mean by the mesh size). ``sum_over_mesh_`` then sums
the parameter gradients over every mesh axis.

``all_gather_frames.bytes`` counts the bytes this rank received in
all-gathers (forward and backward), for the measurement script.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        x = x.contiguous()
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        all_gather_frames.bytes += (n - 1) * x.numel() * x.element_size()
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def all_gather_frames(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (each rank's ``x`` has the same shape), differentiable."""
    return _AllGather.apply(x, group, dim)


all_gather_frames.bytes = 0


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _mean(grad, ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's ``x`` on every rank, differentiable."""
    return _AllReduceMean.apply(x, group)


def _flat_groups(tensors):
    """The tensors bucketed by (dtype, device), in order."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    return buckets.values()


@torch.no_grad()
def sum_over_mesh_(tensors, mesh) -> None:
    """Sum each tensor over every rank of ``mesh``, in place: one
    all-reduce of one flattened buffer per (dtype, device) along each mesh
    axis."""
    for bucket in _flat_groups(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        for name in mesh.mesh_dim_names:
            dist.all_reduce(flat, group=mesh.get_group(name))
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def broadcast_from_first_(tensors, mesh) -> None:
    """Overwrite each tensor with the mesh's first rank's, in place: one
    broadcast of one flattened buffer per (dtype, device) along each mesh
    axis, the last axis first, so that coordinate 0 of every axis holds the
    first rank's values before the next axis reads them."""
    for bucket in _flat_groups(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        for name in reversed(mesh.mesh_dim_names):
            group = mesh.get_group(name)
            dist.broadcast(flat, src=dist.get_global_rank(group, 0),
                           group=group)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view_as(t))


def mesh_barrier(mesh) -> None:
    """Return once every rank of ``mesh`` has reached this call."""
    for name in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(name))
