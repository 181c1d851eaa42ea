"""BiSeNet face parser, an alternative to ParseNet (torch.nn, NCHW,
inference BatchNorm).

Counterpart of ``flair_tpu/models/bisenet.py`` (reference
facelib/parsing/bisenet.py:8-141 and its ResNet18): a context path over
the port's ``resnet18`` with attention-refinement modules, a feature-fusion
module and three output heads, each upsampled to the input size by
align-corners bilinear interpolation. Module names follow the flax scopes
(``utils/convert.from_flax``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm, Conv2d
from .registry import register_model
from .resnet import ConvBN, resnet18


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(o: int, i: int) -> np.ndarray:
    """(o, i) bilinear resample matrix with aligned corners, float32, as
    the JAX package builds it (cached: read only)."""
    m = np.zeros((o, i), np.float32)
    if o == 1:
        m[0, 0] = 1
        return m
    for k in range(o):
        p = k * (i - 1) / (o - 1)
        p0 = int(np.floor(p))
        f = p - p0
        m[k, p0] += 1 - f
        m[k, min(p0 + 1, i - 1)] += f
    return m


def _bilinear_up_align(x: torch.Tensor, out_hw) -> torch.Tensor:
    """F.interpolate(..., mode='bilinear', align_corners=True) of
    (N, C, H, W) as two matmuls."""
    h, w = out_hw
    ry = torch.as_tensor(_align_corners_matrix(h, x.shape[2]),
                         dtype=x.dtype, device=x.device)
    rx = torch.as_tensor(_align_corners_matrix(w, x.shape[3]),
                         dtype=x.dtype, device=x.device)
    y = torch.einsum("uh,bchw->bcuw", ry, x)
    return torch.einsum("vw,bchw->bchv", rx, y)


def _up2_crop(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 by repeat, cropped to ``like``'s size."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :like.shape[2], :like.shape[3]]


class ConvBNReLU(ConvBN):
    """k×k conv (no bias, k // 2 pad) → BatchNorm → ReLU."""

    def forward(self, x):
        return F.relu(super().forward(x))


class AttentionRefinement(nn.Module):
    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, features, 3, dtype=dtype)
        self.conv_atten = Conv2d(features, features, 1, use_bias=False,
                                 dtype=dtype)
        self.bn_atten = BatchNorm(features)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3),
                                                        keepdim=True)))
        return feat * torch.sigmoid(atten)


class FeatureFusion(nn.Module):
    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__()
        self.convblk = ConvBNReLU(in_ch, features, 1, dtype=dtype)
        self.conv1 = Conv2d(features, features // 4, 1, use_bias=False,
                            dtype=dtype)
        self.conv2 = Conv2d(features // 4, features, 1, use_bias=False,
                            dtype=dtype)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(self.conv2(atten)) + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_ch: int, mid: int, num_class: int,
                 dtype=torch.float32):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid, 3, dtype=dtype)
        self.conv_out = Conv2d(mid, num_class, 1, use_bias=False, dtype=dtype)

    def forward(self, x):
        feat = self.conv(x)
        return self.conv_out(feat), feat


@register_model("bisenet")
class BiSeNet(nn.Module):
    """(B, 3, H, W) → three per-pixel class-logit maps (B, num_class, H, W)
    at the input resolution."""

    def __init__(self, num_class: int = 19, dtype=torch.float32):
        super().__init__()
        self.resnet = resnet18(dtype)
        c8, c16, c32 = self.resnet.out_channels[1:]
        self.conv_avg = ConvBNReLU(c32, 128, 1, dtype=dtype)
        self.arm32 = AttentionRefinement(c32, 128, dtype)
        self.conv_head32 = ConvBNReLU(128, 128, 3, dtype=dtype)
        self.arm16 = AttentionRefinement(c16, 128, dtype)
        self.conv_head16 = ConvBNReLU(128, 128, 3, dtype=dtype)
        self.ffm = FeatureFusion(c8 + 128, 256, dtype)
        self.conv_out = BiSeNetOutput(256, 256, num_class, dtype)
        self.conv_out16 = BiSeNetOutput(128, 64, num_class, dtype)
        self.conv_out32 = BiSeNetOutput(128, 64, num_class, dtype)

    def forward(self, x):
        h, w = x.shape[2:]
        _, feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg
        f32_up = self.conv_head32(_up2_crop(f32, feat16))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(_up2_crop(f16, feat8))
        out, _ = self.conv_out(self.ffm(feat8, f16_up))
        out16, _ = self.conv_out16(f16_up)
        out32, _ = self.conv_out32(f32_up)
        return tuple(_bilinear_up_align(o, (h, w)) for o in (out, out16, out32))
