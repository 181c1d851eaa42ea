"""ParseNet, plain float32 (facexlib ``parsing/parsenet.py``, the face
parser of GFPGAN and CodeFormer): a conv of the face, residual blocks that
halve it from ``in_size`` down to ``min_feat_size``, a residual body added
back to their output, residual blocks that double it up to ``out_size``,
and two output convs: the 19 parse classes' logits and an RGB image.

Each conv layer is [nearest ×2] → reflect pad → conv (stride 2 going
down) → [BatchNorm] → [leaky ReLU 0.2]; a block is the shortcut (the
input, or a conv layer where the size or channels change) plus two conv
layers, the second without activation. BatchNorm runs in inference mode
from its running statistics, in float32. Every conv goes through
``nn.Layer.q`` for the control.

Departures from the upstream code, each as the measured program has it:
module names follow the flax scopes of the JAX port (``enc_0``,
``body_3.conv1.bn``, ``dec_2.shortcut``, ``out_mask_conv``), so one seeded
draw by name feeds both sides. The running statistics are the buffers a
freshly built layer holds (mean 0, variance 1): the benchmark draws
parameters only, so they are the program's too.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import Conv2d, _param


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm, eps 1e-5."""

    def __init__(self, channels):
        super().__init__()
        self.weight = _param(channels)
        self.bias = _param(channels)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, scale="none", norm=False, act=False):
        super().__init__()
        self.scale, self.act = scale, act
        self.conv = Conv2d(cin, cout, 3, stride=2 if scale == "down" else 1,
                           padding=0, bias=not norm)
        self.bn = BatchNorm(cout) if norm else None

    def forward(self, x):
        if self.scale == "up":
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        x = self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        if self.bn is not None:
            x = self.bn(x)
        return F.leaky_relu(x, 0.2) if self.act else x


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, scale="none"):
        super().__init__()
        self.shortcut = (ConvLayer(cin, cout, scale)
                         if scale != "none" or cin != cout else None)
        first, second = {"down": ("none", "down"), "up": ("up", "none"),
                         "none": ("none", "none")}[scale]
        self.conv1 = ConvLayer(cin, cout, first, norm=True, act=True)
        self.conv2 = ConvLayer(cout, cout, second, norm=True)

    def forward(self, x):
        identity = x if self.shortcut is None else self.shortcut(x)
        return identity + self.conv2(self.conv1(x))


class ParseNet(nn.Module):
    """``forward(x)`` of (N, 3, in_size, in_size) in [-1, 1] → (logits
    (N, 19, out_size, out_size), image (N, 3, out_size, out_size)).
    Channels double going down and halve going up, held within
    ``ch_range``."""

    def __init__(self, in_size=512, out_size=512, min_feat_size=32,
                 base_ch=64, parsing_ch=19, res_depth=10,
                 relu_type="leakyrelu", ch_range=(32, 256)):
        super().__init__()
        if relu_type != "leakyrelu":
            raise ValueError("the reference writes only leaky ReLU")
        lo, hi = ch_range

        def clip(c):
            return max(lo, min(c, hi))

        mfs = min(in_size, min_feat_size)
        self.down = int(math.log2(in_size // mfs))
        self.up = int(math.log2(out_size // mfs))
        self.depth = res_depth
        self.enc_in = ConvLayer(3, base_ch)
        ch = base_ch
        for i in range(self.down):
            self.add_module(f"enc_{i}", ResidualBlock(clip(ch), clip(2 * ch),
                                                      "down"))
            ch *= 2
        for i in range(res_depth):
            self.add_module(f"body_{i}", ResidualBlock(clip(ch), clip(ch)))
        for i in range(self.up):
            self.add_module(f"dec_{i}", ResidualBlock(clip(ch), clip(ch // 2),
                                                      "up"))
            ch //= 2
        self.out_img_conv = ConvLayer(clip(ch), 3)
        self.out_mask_conv = ConvLayer(clip(ch), parsing_ch)

    def forward(self, x):
        feat = self.enc_in(x)
        for i in range(self.down):
            feat = getattr(self, f"enc_{i}")(feat)
        h = feat
        for i in range(self.depth):
            h = getattr(self, f"body_{i}")(h)
        h = feat + h
        for i in range(self.up):
            h = getattr(self, f"dec_{i}")(h)
        return self.out_mask_conv(h), self.out_img_conv(h)
