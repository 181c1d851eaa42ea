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

from .codeformer import Codebook, adaptive_instance_norm
from .nn import Conv2d, Dense


class TinyCodeFormer(nn.Module):
    """CodeFormer's code path at a tiny size, NCHW: features
    f = silu(conv x), a code head ``idx_pred`` that gives each pixel's
    logits over the ``codes``-entry codebook ``quantize.embedding``, their
    argmax (or the ``codes`` given), the lookup, AdaIN of the looked-up
    codes to f, and x + 2·conv(·): restored faces that leave [-1, 1]
    where the paste's clamps matter, and codes that a lower precision
    flips. ``forward(x, w, adain, codes)`` → (out, logits (N, H·W,
    codes), f)."""

    def __init__(self, width=8, codes=16, dtype=torch.float32):
        super().__init__()
        self.conv_in = Conv2d(3, width)
        self.idx_pred = Dense(width, codes, bias=False)
        self.quantize = Codebook(codes, width)
        self.conv_out = Conv2d(width, 3)

    def lookup(self, codes):
        return self.quantize.lookup(codes)

    def forward(self, x, w=0.0, adain=False, codes=None):
        x = x.float()
        feat = F.silu(self.conv_in(x))
        logits = self.idx_pred(feat.flatten(2).transpose(1, 2))
        if codes is None:
            codes = logits.argmax(-1)
        elif codes.shape != logits.shape[:-1]:
            raise ValueError(f"codes {tuple(codes.shape)} for logits "
                             f"{tuple(logits.shape)}")
        quant = self.lookup(codes).transpose(1, 2).reshape(feat.shape)
        if adain:
            quant = adaptive_instance_norm(quant, feat)
        return x + 2 * self.conv_out(quant), logits, feat


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
