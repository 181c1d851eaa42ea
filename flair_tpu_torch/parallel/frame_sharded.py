"""Frame-axis (sequence) parallelism for the temporal modules.

Counterpart of ``flair_tpu/parallel/frame_sharded.py``. A module that
mixes frames holds a ``frame_group`` attribute (``None``: unsharded):

- ``GroupNorm32`` (and ``ops.norms.group_norm(group=)``): statistics joint
  over the whole clip, from the all-reduced mean of the local moments;
- ``Conv3d``: a ``k_t // 2``-frame halo, zero at the clip's ends;
- ``TemporalAttention``: its norm as above, an ``f // 2``-frame halo
  replicated at the clip's ends, the halo outputs dropped;
- ``BasicVSRPP``: the recurrence is sequential over frames, so the hidden
  state is all-gathered, every rank propagates the whole clip and keeps its
  frames (what GSPMD does in JAX too: K1 runs the unsharded count a rank);
- ``ShiftWindowGroupNorm`` raises (not frame-shardable, as JAX asserts).

``set_frame_group(model, group)`` sets it on every such submodule (``None``
undoes it); the sharded entry points set it around their call. Everything
else in the UNets (time embedding, spatial attention, K2, the gates) works
frame by frame.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .collectives import all_gather_frames
from .halo import halo_exchange_frames
from .mesh import shard


def set_frame_group(model: torch.nn.Module, group) -> None:
    """``frame_group = group`` on every submodule of ``model`` that has
    one."""
    for m in model.modules():
        if hasattr(m, "frame_group"):
            m.frame_group = group


def _rules(mesh, frame_axis: str, data_axis: Optional[str]):
    rules = [] if data_axis is None else [(0, data_axis)]
    return tuple(rules + [(1, frame_axis)])


def _whole(y, mesh, rules):
    """The whole (B, T, ...) result from every rank's local block."""
    for dim, axis in reversed(rules):
        y = all_gather_frames(y, mesh.get_group(axis), dim)
    return y


def frame_sharded(fn: Callable, mesh, *, halo: int, frame_axis: str = "frame",
                  data_axis: Optional[str] = "data") -> Callable:
    """Shard a frame-LOCAL op ``fn((B, T, ...)) -> (B, T, ...)`` (output
    frame t depends only on input frames [t-halo, t+halo], no cross-frame
    statistics) over ``frame_axis`` (and B over ``data_axis``). The wrapped
    op takes the whole (B, T, ...) input on every rank and returns the
    whole output on every rank; T must divide evenly."""
    rules = _rules(mesh, frame_axis, data_axis)

    def wrapped(x):
        xl = shard(x, mesh, rules)
        y = fn(halo_exchange_frames(xl, halo, mesh.get_group(frame_axis)))
        if halo:
            y = y[:, halo:-halo]
        return _whole(y, mesh, rules)

    return wrapped


def frame_sharded_temporal_attention(attn_module, mesh, *,
                                     frame_axis: str = "frame",
                                     data_axis: Optional[str] = "data"
                                     ) -> Callable:
    """Exact frame-sharded forward of a ``TemporalAttention``: the wrapped
    call takes the whole (B, T, H, W, C) input on every rank, runs the
    module on the rank's block with its frame group set (joint norm
    statistics and the halo inside), and returns the whole output."""
    rules = _rules(mesh, frame_axis, data_axis)

    def wrapped(x):
        xl = shard(x, mesh, rules)
        b, t, h, w, c = xl.shape
        set_frame_group(attn_module, mesh.get_group(frame_axis))
        try:
            y = attn_module(xl.reshape(b * t, h, w, c).permute(0, 3, 1, 2),
                            b)
        finally:
            set_frame_group(attn_module, None)
        return _whole(y.permute(0, 2, 3, 1).reshape(b, t, h, w, c), mesh,
                      rules)

    return wrapped
