"""Interpolation resizes (torch F.interpolate semantics) as separable matmuls.

Counterpart of the separable-matrix half of ``flair_tpu/ops/resize.py``
(lines 296-387). The (out, in) resample matrices are built on the host in
float64 numpy — the port keeps its own copy of that code — and applied as
two einsums over the H and W axes of channels-last (..., H, W, C) tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def keys_cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys piecewise-cubic kernel, support [-2, 2] (a=-0.75: cv2/torch)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    x2, x3 = x * x, x * x * x
    inner = (a + 2) * x3 - (a + 3) * x2 + 1
    outer = a * x3 - 5 * a * x2 + 8 * a * x - 4 * a
    return np.where(x <= 1, inner, np.where(x < 2, outer, 0.0))


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(out_size: int, in_size: int, mode: str,
                      a: float = -0.75) -> np.ndarray:
    """(out_size, in_size) row-stochastic resample matrix, float64.

    'bicubic'/'bilinear': half-pixel centres, edge clamping, no antialias
    (F.interpolate align_corners=False). 'bilinear_aa': the antialiased
    triangle kernel on downscale. 'area': adaptive average pooling.
    'nearest': floor-index selection."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "area":
        for i in range(out_size):
            lo = int(np.floor(i * in_size / out_size))
            hi = int(np.ceil((i + 1) * in_size / out_size))
            m[i, lo:hi] = 1.0 / (hi - lo)
        return m
    if mode == "nearest":
        for i in range(out_size):
            m[i, min(int(i * in_size / out_size), in_size - 1)] = 1.0
        return m
    scale = in_size / out_size
    if mode == "bilinear_aa":
        if scale <= 1.0:
            return _interp_matrix_np(out_size, in_size, "bilinear", a)
        for i in range(out_size):
            x = (i + 0.5) * scale - 0.5
            lo = int(np.floor(x - scale)) + 1
            hi = int(np.ceil(x + scale))
            js = np.arange(lo, hi + 1)
            w = np.maximum(0.0, 1.0 - np.abs(js - x) / scale)
            w = w / w.sum()
            for j, wgt in zip(js, w):
                m[i, int(np.clip(j, 0, in_size - 1))] += wgt
        return m
    for i in range(out_size):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        if mode == "bilinear":
            for j, wgt in ((x0, 1 - f), (x0 + 1, f)):
                m[i, int(np.clip(j, 0, in_size - 1))] += wgt
        elif mode == "bicubic":
            offs = np.array([-1, 0, 1, 2])
            for j, wgt in zip(x0 + offs, keys_cubic(offs - f, a)):
                m[i, int(np.clip(j, 0, in_size - 1))] += wgt
        else:
            raise ValueError(f"unknown resize mode: {mode}")
    return m


def resize_matrix(out_size: int, in_size: int, mode: str) -> np.ndarray:
    """Host-side separable resample matrix (a fresh copy)."""
    return _interp_matrix_np(out_size, in_size, mode).copy()


def _separable_resize(x: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    """R_h @ img @ R_wᵀ over the H, W axes of (..., H, W, C)."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = out_hw
    rh = torch.as_tensor(_interp_matrix_np(h_out, h_in, mode),
                         dtype=x.dtype, device=x.device)
    rw = torch.as_tensor(_interp_matrix_np(w_out, w_in, mode),
                         dtype=x.dtype, device=x.device)
    y = torch.einsum("uh,...hwc->...uwc", rh, x)
    return torch.einsum("vw,...hwc->...hvc", rw, y)


def resize_bicubic(x, out_hw):
    """F.interpolate(mode='bicubic', align_corners=False) parity."""
    return _separable_resize(x, out_hw, "bicubic")


def resize_bilinear(x, out_hw):
    """F.interpolate(mode='bilinear', align_corners=False) parity."""
    return _separable_resize(x, out_hw, "bilinear")


def resize_area(x, out_hw):
    """F.interpolate(mode='area') / adaptive average pool parity."""
    return _separable_resize(x, out_hw, "area")


def resize_bilinear_aa(x, out_hw):
    """F.interpolate(mode='bilinear', antialias=True) parity (the reference
    resizes VSR++ flow inputs this way, unet.py:543-550)."""
    return _separable_resize(x, out_hw, "bilinear_aa")
