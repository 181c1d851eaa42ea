"""FFT null-space pseudo-inverse operator for blur + decimation.

Counterpart of ``flair_tpu/operators/pseudo_sr.py`` (reference
pseudoSR.py:15-416). The host side (numpy float64) builds the downscale
kernel, forms hᵀh, inverts it in the Fourier domain with a magnitude floor
and recentres / trims the spatial inverse filter. The device side is three
fixed depthwise convolutions plus strided sampling, on NHWC tensors, with
the filters held on the operator's device.

``A_pinv(y, x)`` returns the null-space correction A⁺A(x) − A⁺(y), with an
optional JPEG round-trip after the downscale (pseudoSR.py:248-281); ``A(x)``
is the degradation itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.jpeg import jpeg_decode, jpeg_encode
from ..ops.resize import (
    calc_strides, depthwise_filter2d, imresize_efficient, imresize_kernel)
from ..utils.device import resolve_device


# the fixed settings of Get_pseudoSR_Conf (pseudoSR.py:397-410)
LOWER_MAGNITUDE_BOUND = 0.01   # floor of |FFT(hᵀh)| before inverting
NFFT_ADD = 36                  # zero padding of hᵀh before the FFT
INV_HTH_HALF_SIZE = 26         # inv(hᵀh) is trimmed to 2·26+1 taps


@dataclasses.dataclass
class PseudoSRConf:
    """pseudoSR configuration: the downscale factor."""

    scale_factor: int = 4


def get_pseudo_sr_conf(sf: int) -> PseudoSRConf:
    return PseudoSRConf(scale_factor=sf)


def _aliased_downsample(arr: np.ndarray, factor: int) -> np.ndarray:
    """Centre-aligned decimation (pseudoSR.py:315-321)."""
    pre, _ = calc_strides(arr.shape, 1.0 / factor, align_center=True)
    return arr[pre[0]::factor, pre[1]::factor]


def _compute_inv_hth(ds_kernel: np.ndarray, sf: int) -> np.ndarray:
    """Fourier-domain inverse of hᵀh with a magnitude floor, recentred on
    its maximum and trimmed (pseudoSR.py:123-171). Host float64 → float32."""
    from scipy.signal import convolve2d

    hth = convolve2d(ds_kernel, np.rot90(ds_kernel, 2)) * sf ** 2
    hth = _aliased_downsample(hth, sf)
    pad = NFFT_ADD // 2
    hth_fft = np.fft.fft2(np.pad(hth, ((pad, pad), (pad, pad))))
    boost = np.maximum(1.0, LOWER_MAGNITUDE_BOUND / np.abs(hth_fft))
    inv = np.real(np.fft.ifft2(1.0 / (hth_fft * boost)))
    n = inv.shape[0]
    max_row, max_col = np.unravel_index(np.argmax(inv), inv.shape)
    if not np.all(np.equal(np.ceil(np.array(inv.shape) / 2),
                           np.array([max_row, max_col]) - 1)):
        half = int(np.min([n - max_row - 1, n - max_col - 1, max_row,
                           max_col]))
        inv = inv[max_row - half:max_row + half + 1,
                  max_col - half:max_col + half + 1]
    drop = inv.shape[0] // 2 - INV_HTH_HALF_SIZE
    if drop > 0:
        inv = inv[drop:-drop, drop:-drop]
    return inv.astype(np.float32)


class PseudoSR:
    """Null-space pseudo-inverse operator (pseudoSR.py:47-295) on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, conf: PseudoSRConf, blur_kernel: Optional[np.ndarray] = None,
                 kernel_indx: int = 0, device=None):
        self.conf = conf
        sf = int(conf.scale_factor)
        self.ds_factor = sf
        self.device = resolve_device(device)
        self.ds_kernel, self.pre_stride, self.post_stride = imresize_kernel(
            sf, blur_kernel, kernel_indx)
        self.inv_hth = _compute_inv_hth(self.ds_kernel.astype(np.float64), sf)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # fixed device filters (pseudoSR_PyTorch.__init__, pseudoSR.py:174-246)
        self._ds_kernel = dev(self.ds_kernel)
        self._inv_hth = dev(self.inv_hth)
        self._downscale_aa = dev(np.rot90(self.ds_kernel, 2))
        self._upscale_aa = dev(self.ds_kernel * sf ** 2)

    # -- building blocks ----------------------------------------------------

    def conv_inv_hth(self, lr: torch.Tensor) -> torch.Tensor:
        """Replication-padded correlation with inv(hᵀh) (pseudoSR.py:189-193)."""
        return depthwise_filter2d(lr, self._inv_hth, padding="edge",
                                  correlate=True)

    def upscale(self, lr: torch.Tensor) -> torch.Tensor:
        """Zero-stuffing upscale + antialias correlation (pseudoSR.py:195-222):
        each LR pixel lands at phase ``pre_stride`` of its sf×sf cell, the
        ``up.at[:, :, pre[0], :, pre[1], :].set(lr)`` of the JAX package on a
        (B, h, sf, w, sf, C) view."""
        b, h, w, c = lr.shape
        sf = self.ds_factor
        up = lr.new_zeros((b, h, sf, w, sf, c))
        up[:, :, int(self.pre_stride[0]), :, int(self.pre_stride[1]), :] = lr
        return depthwise_filter2d(up.reshape(b, h * sf, w * sf, c),
                                  self._upscale_aa, padding="edge",
                                  correlate=True)

    def downscale(self, hr: torch.Tensor) -> torch.Tensor:
        """Antialias correlation + aliased decimation (pseudoSR.py:223-243)."""
        y = depthwise_filter2d(hr, self._downscale_aa, padding="edge",
                               correlate=True)
        b, hh, ww, c = y.shape
        sf = self.ds_factor
        y = y.reshape(b, hh // sf, sf, ww // sf, sf, c)
        return y[:, :, int(self.pre_stride[0]), :, int(self.pre_stride[1]), :]

    # -- operator interface -------------------------------------------------

    def A(self, hr: torch.Tensor, use_zero_padding: bool = False
          ) -> torch.Tensor:
        """The degradation: antialias filter + phase-aligned decimation
        (pseudoSR.py:283-295 → imresize_efficient), reflect-padded by half
        the kernel, or zero-padded with ``use_zero_padding``."""
        return imresize_efficient(hr, self._ds_kernel, self.ds_factor,
                                  self.pre_stride, self.post_stride,
                                  use_zero_padding=use_zero_padding)

    def A_pinv(self, lr: torch.Tensor, generated: Optional[torch.Tensor] = None,
               jpeg_qf: Optional[int] = None) -> torch.Tensor:
        """A⁺A(x_gen) − A⁺(y) with ``generated``, else A⁺(y)
        (pseudoSR.py:248-281). ``jpeg_qf`` inserts the JPEG round-trip after
        the downscale (the jpeg task, scripts/video_sample.py:450-456)."""
        lr = lr[..., -3:]
        ortho_lr = self.upscale(self.conv_inv_hth(lr))
        if generated is None:
            return ortho_lr
        down = self.downscale(generated)
        if jpeg_qf is not None:
            down = jpeg_decode(jpeg_encode(down, jpeg_qf), jpeg_qf)
        return self.upscale(self.conv_inv_hth(down)) - ortho_lr

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        """Scalar DDRM Λ (pseudoSR.py:297-305)."""
        a, sigma_y, sigma_t = (torch.as_tensor(v, dtype=vec.dtype,
                                               device=vec.device)
                               for v in (a, sigma_y, sigma_t))
        factor = sigma_t * (1 - eta ** 2) ** 0.5 / a / sigma_y
        return torch.where(sigma_t.mean() < (a * sigma_y).mean(),
                           vec * factor, vec)

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon=None):
        """Scalar DDRM Λ-noise (pseudoSR.py:307-312)."""
        a, sigma_y, sigma_t = (torch.as_tensor(v, dtype=vec.dtype,
                                               device=vec.device)
                               for v in (a, sigma_y, sigma_t))
        factor = torch.sqrt(torch.clamp(sigma_t ** 2 - a ** 2 * sigma_y ** 2,
                                        min=0.0))
        return torch.where(sigma_t.mean() >= (a * sigma_y).mean(),
                           vec * factor, vec * sigma_t * eta)
