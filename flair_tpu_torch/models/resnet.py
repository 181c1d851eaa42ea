"""ResNet backbones (torch.nn, NCHW, inference BatchNorm).

Counterpart of ``flair_tpu/models/resnet.py``: the RetinaFace detector's
ResNet50 body (torchvision resnet50 in the reference,
retinaface.py:99-103) and ResNet18. Module names follow the flax scopes
(``layer{stage}_{block}``, ``c1``..``c3``, ``downsample``), so
``utils/convert.from_flax`` is a transpose. Every conv pads k // 2 on
both sides, as the flax module's explicit padding does; the stem's max-pool
pads with -inf; a bottleneck strides on its 3×3 conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm, Conv2d


class ConvBN(nn.Module):
    """k×k conv (no bias, symmetric k // 2 pad) → inference BatchNorm."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding=kernel // 2,
                           use_bias=False, dtype=dtype)
        self.bn = BatchNorm(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.c1 = ConvBN(in_ch, features, 3, stride, dtype)
        self.c2 = ConvBN(features, features, 3, 1, dtype)
        if stride != 1 or in_ch != features:
            self.downsample = ConvBN(in_ch, features, 1, stride, dtype)

    def forward(self, x):
        h = self.c2(F.relu(self.c1(x)))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 to 4 × ``features``."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        out_ch = features * 4
        self.c1 = ConvBN(in_ch, features, 1, 1, dtype)
        self.c2 = ConvBN(features, features, 3, stride, dtype)
        self.c3 = ConvBN(features, out_ch, 1, 1, dtype)
        if stride != 1 or in_ch != out_ch:
            self.downsample = ConvBN(in_ch, out_ch, 1, stride, dtype)

    def forward(self, x):
        h = F.relu(self.c1(x))
        h = F.relu(self.c2(h))
        h = self.c3(h)
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(h + identity)


class ResNet(nn.Module):
    """Returns the C2..C5 stage features of an (N, 3, H, W) input."""

    def __init__(self, block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = Conv2d(3, width, 7, 2, padding=3, use_bias=False,
                            dtype=dtype)
        self.bn1 = BatchNorm(width)
        Block = Bottleneck if block == "bottleneck" else BasicBlock
        in_ch, ch = width, width
        for si, n in enumerate(self.layers):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                self.add_module(f"layer{si + 1}_{bi}",
                                Block(in_ch, ch, stride, dtype))
                in_ch = ch * Block.expansion
            ch *= 2
        self.out_channels = [width * Block.expansion * 2 ** i
                             for i in range(len(self.layers))]

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        # F.max_pool2d pads with -inf, as the flax stem's explicit pad does
        h = F.max_pool2d(h, 3, 2, padding=1)
        outs = []
        for si, n in enumerate(self.layers):
            for bi in range(n):
                h = getattr(self, f"layer{si + 1}_{bi}")(h)
            outs.append(h)
        return outs


def resnet50(dtype=torch.float32) -> ResNet:
    return ResNet("bottleneck", (3, 4, 6, 3), 64, dtype)


def resnet18(dtype=torch.float32) -> ResNet:
    return ResNet("basic", (2, 2, 2, 2), 64, dtype)
