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


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of NHWC ``x`` (N, H, W, C) with reflect-101
    padding (cv2 BORDER_DEFAULT). ``F.pad``'s reflect mode reflects at most
    size - 1 pixels, so H and W must exceed ksize // 2; smaller images
    raise (``jnp.pad`` reflects any amount, which the port does not copy)."""
    n, h, w, c = x.shape
    p = ksize // 2
    if min(h, w) <= p:
        raise ValueError(
            f"gaussian_blur: a {ksize}-tap reflect-101 blur needs H and W "
            f"above {p}, got {h}×{w}")
    k = torch.as_tensor(gaussian_kernel_1d(ksize, sigma), dtype=x.dtype,
                        device=x.device)
    v = x.permute(0, 3, 1, 2)
    v = F.conv2d(F.pad(v, (0, 0, p, p), mode="reflect"),
                 k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    v = F.conv2d(F.pad(v, (p, p, 0, 0), mode="reflect"),
                 k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    return v.permute(0, 2, 3, 1)
