"""Grid sampling, optical-flow warping and affine warps.

Counterpart of ``grid_sample`` / ``flow_warp`` / ``warp_affine`` /
``inverse_affine_matrix`` in ``flair_tpu/ops/warp.py`` (lines 278-419;
mmedit ``flow_warp`` and cv2.warpAffine parity). The JAX package computes
these in plain jnp (no Pallas kernel), so the port uses
``F.grid_sample`` on NCHW tensors. Sampling runs in float32 whatever the
activation dtype — bf16 normalized coordinates cannot resolve pixels — and
the result is cast back. ``F.grid_sample``'s bicubic mode is Keys' cubic
with a = -0.75 and, with ``padding_mode="zeros"``, reads taps outside the
image as zero: the JAX package's ``_bicubic_patch_batched``.
"""

from __future__ import annotations

import numpy as np
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


def inverse_affine_matrix(m: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine matrix (host; cv2.invertAffineTransform)."""
    a = np.eye(3, dtype=np.float64)
    a[:2] = m
    return np.linalg.inv(a)[:2].astype(np.float64)


def invert_affine_batch(m: torch.Tensor) -> torch.Tensor:
    """Invert (N, 2, 3) affines on the device, in closed form."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    return torch.stack([torch.stack([ia, ib, ic], -1),
                        torch.stack([id_, ie, if_], -1)], 1)


def warp_affine(img: torch.Tensor, matrix: torch.Tensor, out_hw, *,
                mode: str = "bilinear",
                border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine parity on the device: output pixel (xo, yo) samples
    ``img`` at M⁻¹·(xo, yo, 1).

    ``img`` (B, H, W, C); ``matrix`` (B, 2, 3), the forward src → dst map
    as cv2 takes it. Taps outside the image read zero; output pixels whose
    sample point lies outside the half-pixel box -0.5 ≤ s ≤ size - 0.5
    take ``border_value`` (BORDER_CONSTANT). Coordinates are float32."""
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(mode)
    ho, wo = out_hw
    _, h, w, _ = img.shape
    inv = invert_affine_batch(matrix.float())[:, :, :, None, None]
    gy, gx = torch.meshgrid(
        torch.arange(ho, dtype=torch.float32, device=img.device),
        torch.arange(wo, dtype=torch.float32, device=img.device),
        indexing="ij")
    sx = inv[:, 0, 0] * gx + inv[:, 0, 1] * gy + inv[:, 0, 2]
    sy = inv[:, 1, 0] * gx + inv[:, 1, 1] * gy + inv[:, 1, 2]
    grid = torch.stack([2.0 * sx / max(w - 1, 1) - 1.0,
                        2.0 * sy / max(h - 1, 1) - 1.0], dim=-1)
    v = grid_sample(img.permute(0, 3, 1, 2), grid, mode=mode).permute(
        0, 2, 3, 1)
    inb = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    return torch.where(inb[..., None], v,
                       torch.full((), border_value, dtype=v.dtype,
                                  device=v.device))
