"""MATLAB-compatible imresize as two matmuls.

Counterpart of ``flair_tpu/ops/matlab_resize.py`` (reference resizer.py:7-196,
MATLAB's ``imresize``): the (out, in) weight matrix of each axis is built on
the host in float64 with MATLAB's conventions — the 1-based half-pixel map,
the kernel widened by the scale for antialiased downscaling, weights
normalised to sum 1, symmetric (edge-repeating) boundaries — and applied to
(..., H, W, C) as two matmuls. Kernels: cubic (a = -0.5), lanczos2,
lanczos3, box and linear.

Box upscaling, where the reference resizer raises, follows the JAX
package's well-defined matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x):
    """MATLAB bicubic kernel (a = -0.5, Keys 1981)."""
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((1 < ax) & (ax <= 2))


def _sinc(x):
    x = np.where(x == 0, 1e-32, x)
    return np.sin(np.pi * x) / (np.pi * x)


def _lanczos(x, a):
    return _sinc(x) * _sinc(x / a) * (np.abs(x) < a)


def _box(x):
    return ((-0.5 <= x) & (x < 0.5)).astype(np.float64)


def _linear(x):
    ax = np.abs(x)
    return (1 - ax) * (ax <= 1)


# name -> (kernel, support in input pixels at scale 1)
_KERNELS = {
    "cubic": (_cubic, 4.0),
    "lanczos2": (lambda x: _lanczos(x, 2), 4.0),
    "lanczos3": (lambda x: _lanczos(x, 3), 6.0),
    "box": (_box, 1.0),
    "linear": (_linear, 2.0),
}


@functools.lru_cache(maxsize=None)
def matlab_resize_matrix(in_size: int, out_size: int, kernel: str = "cubic",
                         antialias: bool = True) -> np.ndarray:
    """The (out_size, in_size) float64 resample matrix of one axis."""
    fn, support = _KERNELS[kernel]
    scale = out_size / in_size
    if antialias and scale < 1:
        width = support / scale
        kern = lambda u: scale * fn(scale * u)  # noqa: E731
    else:
        width = support
        kern = fn
    # symmetric boundary: index i past an edge reads the mirror, edge repeated
    mirror = np.concatenate([np.arange(in_size),
                             np.arange(in_size - 1, -1, -1)])
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        # MATLAB's 1-based map: u = (i+1)/scale + 0.5·(1 - 1/scale)
        u = (i + 1) / scale + 0.5 * (1 - 1 / scale)
        left = np.floor(u - width / 2)
        taps = left - 1 + np.arange(int(np.ceil(width)) + 2)   # 0-based
        w = kern(u - (taps + 1))
        s = w.sum()
        if s != 0:
            w = w / s
        idx = mirror[np.mod(taps.astype(np.int64), len(mirror))]
        for j, wj in zip(idx, w):
            m[i, j] += wj
    return m


def matlab_resize(x: torch.Tensor, out_hw, kernel: str = "cubic",
                  antialias: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) to ``out_hw`` with MATLAB imresize semantics
    (resizer.py:7), in x's dtype and on x's device."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    rh = torch.as_tensor(matlab_resize_matrix(h_in, out_hw[0], kernel,
                                              antialias),
                         dtype=x.dtype, device=x.device)
    rw = torch.as_tensor(matlab_resize_matrix(w_in, out_hw[1], kernel,
                                              antialias),
                         dtype=x.dtype, device=x.device)
    y = torch.einsum("uh,...hwc->...uwc", rh, x)
    return torch.einsum("vw,...hwc->...hvc", rw, y)
