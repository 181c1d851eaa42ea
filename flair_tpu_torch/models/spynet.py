"""SPyNet optical flow (mmedit semantics).

Counterpart of ``flair_tpu/models/spynet.py``: ImageNet normalisation, a
6-level average-pool pyramid, coarse-to-fine refinement with a 5-conv
module per level; inputs whose size is not a multiple of 32 are resized and
the flow rescaled back. Images are (N, 3, H, W) in [0, 1]; the flow is
(N, 2, H, W) float32 with channel 0 = dx, such that
``flow_warp(supp, flow) ≈ ref``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp
from .common import Conv2d, channels_last, nchw, nhwc
from .registry import register_model

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class SPyNetBasicModule(nn.Module):
    """One pyramid level: five 7×7 convs 8→32→64→32→16→2, ReLU between."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        chans = (8, 32, 64, 32, 16, 2)
        for i in range(5):
            setattr(self, f"conv{i}",
                    Conv2d(chans[i], chans[i + 1], 7, dtype=dtype))

    def forward(self, x):
        for i in range(5):
            x = getattr(self, f"conv{i}")(x)
            if i < 4:
                x = F.relu(x)
        return x


def _bilinear_up2_align(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='bilinear', align_corners=True) of
    (N, C, H, W), written as the JAX package writes it (row/column gathers
    with float32 fractions)."""
    _, _, h, w = x.shape
    ho, wo = h * 2, w * 2
    dev = x.device
    yi = torch.arange(ho, device=dev) * (h - 1) / max(ho - 1, 1)
    xi = torch.arange(wo, device=dev) * (w - 1) / max(wo - 1, 1)
    y0 = torch.floor(yi).long()
    x0 = torch.floor(xi).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (yi - y0).to(x.dtype)[None, None, :, None]
    fx = (xi - x0).to(x.dtype)[None, None, None, :]
    r0 = x[:, :, y0]
    r1 = x[:, :, y1]
    top = r0[..., x0] * (1 - fx) + r0[..., x1] * fx
    bot = r1[..., x0] * (1 - fx) + r1[..., x1] * fx
    return top * (1 - fy) + bot * fy


@register_model("spynet")
class SPyNet(nn.Module):
    """6-level pyramid flow estimator; ``forward(ref, supp)``."""

    def __init__(self, levels: int = 6, dtype=torch.float32):
        super().__init__()
        self.levels = levels
        for i in range(levels):
            setattr(self, f"level{i}", SPyNetBasicModule(dtype))
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        n, _, h, w = ref.shape
        h32 = -(-h // 32) * 32
        w32 = -(-w // 32) * 32
        need_resize = (h32 != h) or (w32 != w)
        if need_resize:
            ref = nchw(resize_bilinear(nhwc(ref), (h32, w32)))
            supp = nchw(resize_bilinear(nhwc(supp), (h32, w32)))
        mean = self.mean.to(ref.dtype)
        std = self.std.to(ref.dtype)
        refs = [channels_last((ref - mean) / std)]
        supps = [channels_last((supp - mean) / std)]
        for _ in range(self.levels - 1):
            refs.append(F.avg_pool2d(refs[-1], 2, 2))
            supps.append(F.avg_pool2d(supps[-1], 2, 2))
        refs = refs[::-1]
        supps = supps[::-1]
        flow = torch.zeros((n, 2, h32 // 32, w32 // 32), dtype=ref.dtype,
                           device=ref.device)
        for lvl in range(self.levels):
            flow_up = flow if lvl == 0 else _bilinear_up2_align(flow) * 2.0
            inp = torch.cat([
                refs[lvl],
                flow_warp(supps[lvl], flow_up, padding_mode="border"),
                flow_up.to(refs[lvl].dtype),
            ], dim=1)
            flow = flow_up + getattr(self, f"level{lvl}")(
                channels_last(inp)).to(flow_up.dtype)
        if need_resize:
            flow = nchw(resize_bilinear(nhwc(flow), (h, w)))
            scale = torch.tensor([w / w32, h / h32], dtype=flow.dtype,
                                 device=flow.device).view(1, 2, 1, 1)
            flow = flow * scale
        return flow.contiguous()


def compute_flow_bidirectional(spynet: SPyNet, lqs: torch.Tensor):
    """(B, T, H, W, 3) in [-1, 1] → (flows_forward, flows_backward), each
    (B, T-1, H, W, 2) with channel 0 = dx: BasicVSRPP.compute_flow
    (unet.py:383-404), the frames clamped to [0, 1] first."""
    lqs01 = torch.clamp((lqs + 1.0) / 2.0, 0.0, 1.0)
    b, t, h, w, c = lqs01.shape
    l1 = nchw(lqs01[:, :-1].reshape(b * (t - 1), h, w, c))
    l2 = nchw(lqs01[:, 1:].reshape(b * (t - 1), h, w, c))
    fwd = nhwc(spynet(l2, l1)).reshape(b, t - 1, h, w, 2)
    bwd = nhwc(spynet(l1, l2)).reshape(b, t - 1, h, w, 2)
    return fwd, bwd
