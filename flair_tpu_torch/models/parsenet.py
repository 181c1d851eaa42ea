"""ParseNet face parser (torch.nn, NCHW).

Counterpart of ``flair_tpu/models/parsenet.py`` (reference
facelib/parsing/parsenet.py:1-194): 19-class face parsing at 512², used by
the face paste-back for its blend mask and by the x8/x16 pipeline for the
VSR++ background weights. BatchNorm runs in inference mode from the stored
running statistics (flax's ``batch_stats`` collection), in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, random_init_
from .registry import register_model


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm (flax ``use_running_average=True``, eps
    1e-5), float32 out."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class PNConv(nn.Module):
    """[nearest ×2] → reflect pad ⌈(k-1)/2⌉ → conv (stride 2 going down) →
    [BatchNorm] → [leaky 0.2 | relu | prelu] (parsenet.py:75-110)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 scale: str = "none", norm: bool = False,
                 relu_type: str = "none", dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.relu_type = relu_type
        self.pad = math.ceil((kernel_size - 1) / 2)
        self.conv = Conv2d(in_ch, out_ch, kernel_size,
                           stride=2 if scale == "down" else 1, padding=0,
                           use_bias=not norm, dtype=dtype)
        if norm:
            self.bn = BatchNorm(out_ch)
        if relu_type == "prelu":
            self.prelu = nn.Parameter(torch.full((out_ch,), 0.25))

    def forward(self, x):
        if self.scale == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        p = self.pad
        x = self.conv(F.pad(x, (p, p, p, p), mode="reflect"))
        if hasattr(self, "bn"):
            x = self.bn(x)
        if self.relu_type == "relu":
            x = F.relu(x)
        elif self.relu_type == "leakyrelu":
            x = F.leaky_relu(x, 0.2)
        elif self.relu_type == "prelu":
            x = torch.where(x >= 0, x, self.prelu.view(1, -1, 1, 1) * x)
        return x


class PNResidualBlock(nn.Module):
    """Residual block, optionally up or down by 2 (parsenet.py:113-135)."""

    def __init__(self, in_ch: int, out_ch: int, scale: str = "none",
                 relu_type: str = "leakyrelu", dtype=torch.float32):
        super().__init__()
        if not (scale == "none" and in_ch == out_ch):
            self.shortcut = PNConv(in_ch, out_ch, 3, scale, dtype=dtype)
        first, second = {"down": ("none", "down"), "up": ("up", "none"),
                         "none": ("none", "none")}[scale]
        self.conv1 = PNConv(in_ch, out_ch, 3, first, norm=True,
                            relu_type=relu_type, dtype=dtype)
        self.conv2 = PNConv(out_ch, out_ch, 3, second, norm=True,
                            relu_type="none", dtype=dtype)

    def forward(self, x):
        identity = self.shortcut(x) if hasattr(self, "shortcut") else x
        return identity + self.conv2(self.conv1(x))


@register_model("parsenet")
class ParseNet(nn.Module):
    """Encoder → residual body → decoder parser (parsenet.py:140-194).
    ``forward(x)`` takes (B, 3, in_size, in_size) in [-1, 1] and returns
    (mask_logits (B, 19, S, S), out_img (B, 3, S, S)), S = out_size."""

    def __init__(self, in_size: int = 512, out_size: int = 512,
                 min_feat_size: int = 32, base_ch: int = 64,
                 parsing_ch: int = 19, res_depth: int = 10,
                 relu_type: str = "leakyrelu",
                 ch_range: Sequence[int] = (32, 256), dtype=torch.float32):
        super().__init__()
        min_ch, max_ch = ch_range

        def clip(c):
            return max(min_ch, min(c, max_ch))

        mfs = min(in_size, min_feat_size)
        self.down_steps = int(math.log2(in_size // mfs))
        self.up_steps = int(math.log2(out_size // mfs))
        self.res_depth = res_depth
        self.enc_in = PNConv(3, base_ch, 3, dtype=dtype)
        ch, c_in = base_ch, base_ch
        for i in range(self.down_steps):
            self.add_module(f"enc_{i}", PNResidualBlock(
                c_in, clip(ch * 2), "down", relu_type, dtype))
            c_in, ch = clip(ch * 2), ch * 2
        for i in range(res_depth):
            self.add_module(f"body_{i}", PNResidualBlock(
                c_in, clip(ch), "none", relu_type, dtype))
            c_in = clip(ch)
        for i in range(self.up_steps):
            self.add_module(f"dec_{i}", PNResidualBlock(
                c_in, clip(ch // 2), "up", relu_type, dtype))
            c_in, ch = clip(ch // 2), ch // 2
        self.out_img_conv = PNConv(c_in, 3, 3, dtype=dtype)
        self.out_mask_conv = PNConv(c_in, parsing_ch, 3, dtype=dtype)

    def random_init(self, seed: int = 0, scale: float = 0.02) -> None:
        random_init_(self, seed, scale)

    def forward(self, x):
        h = self.enc_in(x)
        for i in range(self.down_steps):
            h = getattr(self, f"enc_{i}")(h)
        feat = h
        for i in range(self.res_depth):
            h = getattr(self, f"body_{i}")(h)
        h = feat + h
        for i in range(self.up_steps):
            h = getattr(self, f"dec_{i}")(h)
        return self.out_mask_conv(h), self.out_img_conv(h)
