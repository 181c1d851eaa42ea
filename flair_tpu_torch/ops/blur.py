"""Gaussian blur as separable depthwise convs (cv2.GaussianBlur parity).

Counterpart of ``flair_tpu/ops/blur.py``: the face paste-back softens its
mask with two 101-tap passes (face_restoration_helper.py:305-321), on the
device so the whole paste stays inside the sampler step. The JAX package
computes it with XLA convolutions, so the port uses ``F.conv2d`` (cuDNN):
one depthwise pass along H, one along W.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel parity (host, float64)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


@functools.lru_cache(maxsize=None)
def reflect_indices(n: int, p: int) -> np.ndarray:
    """Source rows of an axis of ``n`` padded by ``p`` on each side with
    ``jnp.pad(mode="reflect")``'s rule, for any ``p``: reflect-101 with
    period 2(n - 1), the edge repeated when n = 1."""
    i = np.arange(-p, n + p)
    if n == 1:
        return np.zeros_like(i)
    m = np.mod(i, 2 * (n - 1))
    return np.where(m < n, m, 2 * (n - 1) - m)


def reflect_pad(v: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """``v`` padded by ``p`` on each side of ``dim`` by ``jnp.pad``'s
    reflect rule (:func:`reflect_indices`)."""
    idx = torch.as_tensor(reflect_indices(v.shape[dim], p), device=v.device)
    return v.index_select(dim, idx)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of NHWC ``x`` (N, H, W, C) with reflect-101
    padding (cv2 BORDER_DEFAULT), for any H and W: an axis shorter than the
    pad reflects again, as ``jnp.pad`` does."""
    c = x.shape[-1]
    p = ksize // 2
    k = torch.as_tensor(gaussian_kernel_1d(ksize, sigma), dtype=x.dtype,
                        device=x.device)
    v = x.permute(0, 3, 1, 2)
    v = F.conv2d(reflect_pad(v, 2, p),
                 k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    v = F.conv2d(reflect_pad(v, 3, p),
                 k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    return v.permute(0, 2, 3, 1)
