"""Two small face networks for the CPU tests of the face prior: a
CodeFormer-like restorer and a ParseNet-like parser with the interfaces
that the port's wrappers and ``face.py`` call, built from the reference's
layers. The tests register each class as a program model too, so that it
serves as its own reference. They take the program's ``dtype`` and
compute in float32, as the tests run."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import Conv2d


class TinyCodeFormer(nn.Module):
    """x + 2·conv(silu(conv x)): restored faces that leave [-1, 1] where
    the paste's clamps matter. ``forward(x, w, adain)`` → (out, None,
    None), NCHW."""

    def __init__(self, width=8, dtype=torch.float32):
        super().__init__()
        self.conv_in = Conv2d(3, width)
        self.conv_out = Conv2d(width, 3)

    def forward(self, x, w=0.0, adain=False):
        x = x.float()
        return x + 2 * self.conv_out(F.silu(self.conv_in(x))), None, None


class TinyParseNet(nn.Module):
    """conv(silu(conv x)) → (logits (N, classes, H, W), None), the
    background class raised by ``background`` so that a share of each
    frame parses as background, as a face frame's surroundings do."""

    def __init__(self, width=8, classes=19, background=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.conv_in = Conv2d(3, width)
        self.conv_out = Conv2d(width, classes)
        self.background = background

    def forward(self, x):
        logits = self.conv_out(F.silu(self.conv_in(x.float())))
        return torch.cat([logits[:, :1] + self.background, logits[:, 1:]],
                         1), None
