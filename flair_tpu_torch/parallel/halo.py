"""Halo exchange for frame-axis (sequence) parallelism.

Counterpart of ``flair_tpu/parallel/halo.py``. The temporal attention
window is ≤7 frames and the temporal convs are 3 frames wide, so a rank
holding a block of frames needs only ``halo`` frames of each neighbour.
JAX ppermutes them; here one ``all_gather_frames`` carries every rank's
head and tail ``halo`` frames (gloo's send / recv take no CUDA tensors),
and its backward sends each halo's gradient back to its owner.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import all_gather_frames


def halo_exchange_frames(x: torch.Tensor, halo: int, group, *,
                         edge: str = "replicate", b=None) -> torch.Tensor:
    """(B, T_local, ...) → (B, T_local + 2·halo, ...) with the neighbours'
    frames; with ``b``, x is the port's (B·T_local, C, H, W) layout and
    the result (B·(T_local + 2·halo), C, H, W) channels_last.

    The clip's ends (the first rank's head, the last rank's tail) get
    ``edge``: ``"replicate"`` copies of the edge frame, as the temporal
    window attention pads (halo.py:41-50), or ``"zero"`` frames, as the
    3-D convs pad."""
    if edge not in ("replicate", "zero"):
        raise ValueError(f"unknown edge: {edge!r}")
    if halo == 0:
        return x
    if b is not None:
        n, c, h, w = x.shape
        v = x.permute(0, 2, 3, 1).reshape(b, n // b, h, w, c)
    else:
        v = x
    t = v.shape[1]
    if t < halo:
        raise ValueError(f"{t} local frames cannot give a {halo}-frame halo")
    ends = all_gather_frames(torch.cat([v[:, :halo], v[:, -halo:]], 1),
                             group, 1)
    r, size = dist.get_rank(group), dist.get_world_size(group)

    def fill(edge_frame):
        if edge == "zero":
            return torch.zeros_like(v[:, :halo])
        return edge_frame.expand((-1, halo) + tuple(v.shape[2:]))

    left = (fill(v[:, :1]) if r == 0 else
            ends[:, (2 * r - 1) * halo:2 * r * halo])
    right = (fill(v[:, -1:]) if r == size - 1 else
             ends[:, 2 * (r + 1) * halo:(2 * r + 3) * halo])
    out = torch.cat([left, v, right], 1)
    if b is None:
        return out
    return out.reshape(-1, h, w, c).permute(0, 3, 1, 2)
