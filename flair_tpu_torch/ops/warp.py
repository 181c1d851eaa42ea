"""Grid sampling and optical-flow warping.

Counterpart of ``grid_sample`` / ``flow_warp`` in ``flair_tpu/ops/warp.py``
(lines 278-362; mmedit ``flow_warp`` parity). The JAX package computes
these in plain jnp (no Pallas kernel), so the port uses
``F.grid_sample`` on NCHW tensors. Sampling runs in float32 whatever the
activation dtype — bf16 normalized coordinates cannot resolve pixels — and
the result is cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor, *,
                mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = True) -> torch.Tensor:
    """``img`` (N, C, H, W); ``grid`` (N, Ho, Wo, 2) normalized coords in
    [-1, 1], grid[..., 0] = x. Returns (N, C, Ho, Wo) in img.dtype."""
    out = F.grid_sample(img.float(), grid.float(), mode=mode,
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(img.dtype)


def flow_warp(x: torch.Tensor, flow, *, interpolation: str = "bilinear",
              padding_mode: str = "zeros",
              align_corners: bool = True) -> torch.Tensor:
    """Warp ``x`` (N, C, H, W) by pixel displacements: ``flow`` is
    (N, 2, H, W) with channel 0 = dx, or a tuple ``(fdx, fdy)`` of (N, H, W)
    planes. Samples x at (col + dx, row + dy)."""
    n, _, h, w = x.shape
    if isinstance(flow, (tuple, list)):
        fdx, fdy = flow
    else:
        fdx, fdy = flow[:, 0], flow[:, 1]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    vx = gx[None] + fdx.float()
    vy = gy[None] + fdy.float()
    nx = 2.0 * vx / max(w - 1, 1) - 1.0
    ny = 2.0 * vy / max(h - 1, 1) - 1.0
    return grid_sample(x, torch.stack([nx, ny], dim=-1), mode=interpolation,
                       padding_mode=padding_mode, align_corners=align_corners)
