"""SuperSloMo frame interpolator.

Counterpart of ``flair_tpu/models/superslomo.py`` (reference
superslomo.py:8-291): a flow UNet (6 → 4, both flows) and an interpolation
UNet (20 → 5, flow residues and visibility) with backward warps between.
``SSUNet`` and ``_back_warp`` are also DAVSRNet's temporal initialiser.

Frames are (B, H, W, 3) in [-1, 1], as in the JAX package; inside, NCHW
channels_last.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import grid_sample
from .common import Conv2d, channels_last, leaky_relu, nchw, nhwc
from .registry import register_model

MEAN = (0.429, 0.431, 0.397)


def mean_tensor(like: torch.Tensor) -> torch.Tensor:
    """The reference's RGB mean as a (3,) tensor on ``like``'s device."""
    return torch.tensor(MEAN, dtype=like.dtype, device=like.device)


class SSDown(nn.Module):
    """2× average pool (floor on odd sizes, flax VALID), then two
    conv + LeakyReLU(0.1) (superslomo.py:8-80)."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, kernel, dtype=dtype)
        self.conv2 = Conv2d(features, features, kernel, dtype=dtype)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 2)
        x = leaky_relu(self.conv1(x), 0.1)
        return leaky_relu(self.conv2(x), 0.1)


class SSUp(nn.Module):
    """Bilinear 2× (``ops.resize.resize_bilinear``), conv, concat skip,
    conv (superslomo.py:82-144)."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, dtype=dtype)
        self.conv2 = Conv2d(features + skip_ch, features, 3, dtype=dtype)

    def forward(self, x, skip):
        h, w = x.shape[2], x.shape[3]
        x = channels_last(nchw(resize_bilinear(nhwc(x), (2 * h, 2 * w))))
        x = leaky_relu(self.conv1(x), 0.1)
        return leaky_relu(self.conv2(torch.cat([x, skip], dim=1)), 0.1)


class SSUNet(nn.Module):
    """6-level UNet (superslomo.py:146-215)."""

    def __init__(self, in_ch: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 32, 7, dtype=dtype)
        self.conv2 = Conv2d(32, 32, 7, dtype=dtype)
        downs = ((32, 64, 5), (64, 128, 3), (128, 256, 3), (256, 512, 3),
                 (512, 512, 3))
        for i, (ci, co, k) in enumerate(downs):
            setattr(self, f"down{i + 1}", SSDown(ci, co, k, dtype))
        ups = ((512, 512, 512), (512, 256, 256), (256, 128, 128),
               (128, 64, 64), (64, 32, 32))
        for i, (ci, cs, co) in enumerate(ups):
            setattr(self, f"up{i + 1}", SSUp(ci, cs, co, dtype))
        self.conv3 = Conv2d(32, out_channels, 3, dtype=dtype)

    def forward(self, x):
        x = leaky_relu(self.conv1(x), 0.1)
        skips = [leaky_relu(self.conv2(x), 0.1)]
        for i in range(1, 5):
            skips.append(getattr(self, f"down{i}")(skips[-1]))
        x = self.down5(skips[-1])
        for i in range(1, 6):
            x = getattr(self, f"up{i}")(x, skips[5 - i])
        return leaky_relu(self.conv3(x), 0.1)


def _back_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp with the reference's own grid normalisation
    (superslomo.py:225-247): x_norm = 2(x/W − 0.5), ``align_corners=False``,
    zero padding. ``img`` (N, C, H, W); ``flow`` (N, 2, H, W), channel 0 =
    dx."""
    _, _, h, w = img.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    x = gx[None] + flow[:, 0]
    y = gy[None] + flow[:, 1]
    grid = torch.stack([2 * (x / w - 0.5), 2 * (y / h - 0.5)], dim=-1)
    return grid_sample(img, grid, align_corners=False)


def slomo_blend(interp_net: SSUNet, i0, i1, f01, f10, t: float):
    """One intermediate frame at time ``t`` from the mean-subtracted frames
    and both flows, NCHW (superslomo.py:262-289; davsr.py:1811-1833)."""
    temp = -t * (1 - t)
    ft0 = temp * f01 + (t * t) * f10
    ft1 = ((1 - t) * (1 - t)) * f01 + temp * f10
    g0 = _back_warp(i0, ft0)
    g1 = _back_warp(i1, ft1)
    io = interp_net(channels_last(
        torch.cat([i0, i1, f01, f10, ft1, ft0, g1, g0], dim=1)))
    ft0f = io[:, :2] + ft0
    ft1f = io[:, 2:4] + ft1
    vt0 = torch.sigmoid(io[:, 4:5])
    vt1 = 1 - vt0
    return ((1 - t) * vt0 * _back_warp(i0, ft0f)
            + t * vt1 * _back_warp(i1, ft1f)) / ((1 - t) * vt0 + t * vt1)


@register_model("superslomo")
class SuperSloMo(nn.Module):
    """frame0 / frame1 (B, H, W, 3) in [-1, 1] → ``factor − 1``
    intermediate frames (B, factor − 1, H, W, 3) (superslomo.py:249-291)."""

    def __init__(self, factor: int = 2, dtype=torch.float32):
        super().__init__()
        self.factor = factor
        self.flow_estimator = SSUNet(6, 4, dtype)
        self.interp = SSUNet(20, 5, dtype)

    def forward(self, frame0, frame1, return_flow: bool = False):
        mean = mean_tensor(frame0)
        i0 = channels_last(nchw((frame0 + 1) / 2 - mean))
        i1 = channels_last(nchw((frame1 + 1) / 2 - mean))
        flow_out = self.flow_estimator(torch.cat([i0, i1], dim=1))
        f01, f10 = flow_out[:, :2], flow_out[:, 2:]
        frames = [nhwc(slomo_blend(self.interp, i0, i1, f01, f10,
                                   i / self.factor))
                  for i in range(1, self.factor)]
        out = (torch.stack(frames, dim=1) + mean) * 2 - 1
        if return_flow:
            return out, nhwc(f01), nhwc(f10)
        return out
