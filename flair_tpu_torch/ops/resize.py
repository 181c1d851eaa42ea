"""Resizes: MATLAB-style antialiased decimation and interpolation resizes.

Counterpart of ``flair_tpu/ops/resize.py``; the port keeps its own copy of
the host code:
- the imresize half (lines 37-288): cubic kernel synthesis, the
  pre/post decimation phases and the centre-of-mass recentring of a
  supplied blur kernel run on the host in float64 numpy (scipy as in the
  JAX module); the device side is a depthwise filter (grouped ``F.conv2d``)
  plus strided sampling — the pseudoSR ``A`` operator;
- the separable-matrix half (lines 296-387): (out, in) resample matrices
  built on the host in float64 and applied as two einsums over the H and W
  axes of channels-last (..., H, W, C) tensors (torch F.interpolate
  semantics).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .blur import reflect_pad


def keys_cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys piecewise-cubic kernel, support [-2, 2] (a=-0.75: cv2/torch)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    x2, x3 = x * x, x * x * x
    inner = (a + 2) * x3 - (a + 3) * x2 + 1
    outer = a * x3 - 5 * a * x2 + 8 * a * x - 4 * a
    return np.where(x <= 1, inner, np.where(x < 2, outer, 0.0))


# ---------------------------------------------------------------------------
# imresize: kernel synthesis (host, float64)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cubic_kernel_1d(sf: int, a: float = -0.75) -> np.ndarray:
    """1-D upscale-by-``sf`` cubic kernel trimmed to its nonzero support:
    the centre row of the reference's cv2 delta-image construction
    (imresize_pseudoSR.py:96-102), the Keys kernel sampled at
    x_i = (i + 0.5)/sf − 0.5 − c."""
    n = 11  # delta image size, as in the reference
    c = int(np.ceil(n / 2)) - 1
    i = np.arange(sf * n, dtype=np.float64)
    k = keys_cubic((i + 0.5) / sf - 0.5 - c, a)
    nz = np.nonzero(np.abs(k) > 0)[0]
    return k[nz[0]:nz[-1] + 1]


def cubic_kernel_2d(sf: int, a: float = -0.75) -> np.ndarray:
    """Separable 2-D cubic upscale kernel (imresize_pseudoSR.py:96-102)."""
    k = cubic_kernel_1d(sf, a)
    return np.outer(k, k)


def calc_strides(shape, factor, align_center: bool = False):
    """(pre_stride, post_stride) decimation phases for an integer scale
    factor (imresize_pseudoSR.py:81-94), each a length-2 int64 array."""
    integer_factor = int(np.maximum(factor, 1.0 / factor))
    if align_center:
        half = np.ceil(np.array(shape[:2], dtype=np.float64) / 2
                       * (factor if factor > 1 else 1))
        pre = np.mod(half, integer_factor)
        pre[pre == 0] = integer_factor
        pre = (pre - 1).astype(np.int64)
        post = integer_factor - pre - 1
    else:
        post = (np.floor(integer_factor / 2) * np.ones(2)).astype(np.int64)
        pre = (integer_factor - post - 1).astype(np.int64)
    return pre, post


def _energy_distribution(kern: np.ndarray) -> np.ndarray:
    """Relative L2 energy kept when trimming n-pixel margins
    (imresize_pseudoSR.py:159-161)."""
    total = np.sqrt(np.sum(kern ** 2))
    vals = [total] + [np.sqrt(np.sum(kern[n:-n, n:-n] ** 2))
                      for n in range(1, int(np.ceil(kern.shape[0] / 2)))]
    return np.asarray(vals) / total


def center_mass(kernel: np.ndarray, ds_factor: int) -> np.ndarray:
    """Recentre a square blur kernel on its centre of mass, then trim it to
    a conv-valid size that fits ``ds_factor`` (imresize_pseudoSR.py:121-157).
    Host float64."""
    assert kernel.shape[0] == kernel.shape[1], "square kernels only"
    from scipy.signal import convolve2d

    n = kernel.shape[0]
    xg, yg = np.meshgrid(np.arange(n), np.arange(n))
    xg = convolve2d(xg, kernel, mode="valid") + 1
    yg = convolve2d(yg, kernel, mode="valid") + 1
    x_pad, y_pad = 2 * (n / 2 - xg), 2 * (n / 2 - yg)
    padding_diff = np.round(np.abs(y_pad)) - np.round(np.abs(x_pad))
    pre_x, post_x = np.maximum(0, -x_pad), np.maximum(0, x_pad)
    pre_y, post_y = np.maximum(0, -y_pad), np.maximum(0, y_pad)

    def r2i(v):
        return int(np.round(np.asarray(v).item()))

    def split_padding(pre, post, diff):
        offset_right = np.round(post) - post - (np.round(pre) - pre)
        pre, post = r2i(pre), r2i(post)
        if offset_right > 0:
            post += int(np.ceil(diff / 2))
            pre += int(np.floor(diff / 2))
        else:
            pre += int(np.ceil(diff / 2))
            post += int(np.floor(diff / 2))
        return pre, post

    if padding_diff > 0:
        pre_y, post_y = r2i(pre_y), r2i(post_y)
        pre_x, post_x = split_padding(pre_x, post_x, padding_diff)
    elif padding_diff < 0:
        pre_x, post_x = r2i(pre_x), r2i(post_x)
        pre_y, post_y = split_padding(pre_y, post_y, -padding_diff)
    else:
        pre_x, post_x = r2i(pre_x), r2i(post_x)
        pre_y, post_y = r2i(pre_y), r2i(post_y)
    kernel = np.pad(kernel, ((pre_y, post_y), (pre_x, post_x)))
    assert kernel.shape[0] == kernel.shape[1]

    margins = (np.argwhere(_energy_distribution(kernel) < 0.99)[0][0]
               * np.ones(2, dtype=np.int64))
    idx = 0
    while np.mod(kernel.shape[0] - np.sum(margins) - 1
                 + np.mod(ds_factor + 1, 2), ds_factor) != 0:
        margins[idx] -= 1
        idx = (idx + 1) % 2
    kernel = kernel[margins[0]:-margins[1], margins[0]:-margins[1]]
    return kernel / np.sum(kernel)


def imresize_kernel(ds_factor: int, blur_kernel: np.ndarray | None = None,
                    kernel_indx: int = 0):
    """(ds_kernel, pre_stride, post_stride) of the pseudoSR downscale
    (pseudoSR.py:332-343 Return_kernel, imresize_pseudoSR.py:10-62):

    - ``blur_kernel is None`` → the pure cubic kernel;
    - ``kernel_indx >= 8`` → the supplied kernel, recentred, replaces it
      (the demo's kernels_12.mat[0, 3] path);
    - ``kernel_indx < 8`` → cubic ⊛ blur kernel.

    ``ds_kernel`` is float32, sums to 1 and is already rotated by 180° for
    downscaling (which moves the even-factor padding to the other side)."""
    from scipy.signal import convolve2d

    sf = int(ds_factor)
    pre, post = calc_strides((0, 0), sf)
    post_padding = np.maximum(0, pre - post)
    pre_padding = np.maximum(0, post - pre)
    if blur_kernel is None:
        up = cubic_kernel_2d(sf)
    elif kernel_indx >= 8:
        assert abs(1.0 - np.sum(blur_kernel)) < np.finfo(np.float32).eps
        up = center_mass(np.asarray(blur_kernel, np.float64), sf) * sf ** 2
    else:
        up = convolve2d(cubic_kernel_2d(sf), np.asarray(blur_kernel, np.float64))
    up = np.pad(up, ((pre_padding[0], post_padding[0]),
                     (pre_padding[1], post_padding[1])))
    ds_kernel = (up[::-1, ::-1] / sf ** 2).astype(np.float32)
    return ds_kernel, pre, post


# ---------------------------------------------------------------------------
# imresize: device side
# ---------------------------------------------------------------------------

def depthwise_filter2d(x: torch.Tensor, kernel, *, padding: str = "reflect",
                       correlate: bool = False) -> torch.Tensor:
    """One shared 2-D kernel applied to every channel of NHWC ``x`` as a
    grouped ``F.conv2d``. True convolution by default (the kernel flipped,
    the reference's rot90(k, 2)-then-correlate, imresize_pseudoSR.py:165-178).
    ``padding``, by half the kernel size: 'reflect' (no edge repeat, by
    ``jnp.pad``'s rule for any amount, so an image narrower than the pad
    reflects again), 'edge', 'zero', or 'none' (the valid output)."""
    if not isinstance(kernel, torch.Tensor):
        kernel = torch.from_numpy(np.ascontiguousarray(kernel))
    k = kernel.to(dtype=x.dtype, device=x.device)
    if not correlate:
        k = k.flip(0, 1)
    kh, kw = k.shape
    c = x.shape[-1]
    v = x.permute(0, 3, 1, 2)
    if padding == "reflect":
        v = reflect_pad(reflect_pad(v, 2, kh // 2), 3, kw // 2)
    elif padding in ("edge", "zero"):
        v = F.pad(v, (kw // 2, kw // 2, kh // 2, kh // 2),
                  mode="replicate" if padding == "edge" else "constant")
    elif padding != "none":
        raise ValueError(f"unknown padding: {padding!r}")
    y = F.conv2d(v, k.expand(c, 1, kh, kw).contiguous(), groups=c)
    return y.permute(0, 2, 3, 1)


def imresize_efficient(x: torch.Tensor, ds_kernel, ds_factor: int,
                       pre_stride, post_stride, *,
                       use_zero_padding: bool = False) -> torch.Tensor:
    """Antialias filter (reflect padding, or zero with
    ``use_zero_padding``) + phase-aligned decimation of NHWC ``x``: the
    pseudoSR ``A`` operator (imresize_pseudoSR.py:163-178). ``post_stride``
    is taken, as the JAX package takes it, and not read."""
    y = depthwise_filter2d(x, ds_kernel,
                           padding="zero" if use_zero_padding else "reflect")
    return y[:, int(pre_stride[0])::ds_factor, int(pre_stride[1])::ds_factor]


def matlab_imresize(x: torch.Tensor, ds_factor: int, blur_kernel=None,
                    kernel_indx: int = 0) -> torch.Tensor:
    """Full imresize, downscale path (imresize_pseudoSR.py:10-79)."""
    k, pre, post = imresize_kernel(ds_factor, blur_kernel, kernel_indx)
    return imresize_efficient(x, k, ds_factor, pre, post)


# ---------------------------------------------------------------------------
# Interpolation resizes (torch F.interpolate semantics) as matmuls
# ---------------------------------------------------------------------------


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
