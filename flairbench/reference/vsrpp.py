"""SPyNet flow and BasicVSR++ second-order propagation with flow-guided
modulated deformable alignment, plain float32 (mmedit semantics, as
FLAIR's unet.py uses them).

The deformable convolution is written from its definition: each of the 9
taps of each deform group samples the input bilinearly at its offset
position (corners outside the image read zero), the sample is scaled by
its mask, and one matrix product with the (Cout, Cin·9) weight sums them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import Conv2d, Layer, _param, flow_warp

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class SPyNet(nn.Module):
    """6-level pyramid: ImageNet-normalised inputs, 2×2 mean pooling, and
    per level five 7×7 convs 8→32→64→32→16→2 refining the doubled,
    upsampled flow. ``forward(ref, supp)`` on (N, 3, H, W) in [0, 1], H and
    W multiples of 32; returns (N, 2, H, W), channel 0 = dx."""

    def __init__(self):
        super().__init__()
        ch = (8, 32, 64, 32, 16, 2)
        for i in range(6):
            lvl = nn.Module()
            for j in range(5):
                setattr(lvl, f"conv{j}", Conv2d(ch[j], ch[j + 1], 7))
            setattr(self, f"level{i}", lvl)

    def forward(self, ref, supp):
        n, _, h, w = ref.shape
        if h % 32 or w % 32:
            raise ValueError("SPyNet reference: sizes must be multiples of 32")
        mean = torch.tensor(MEAN, device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=ref.device).view(1, 3, 1, 1)
        refs, supps = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(5):
            refs.append(F.avg_pool2d(refs[-1], 2))
            supps.append(F.avg_pool2d(supps[-1], 2))
        flow = torch.zeros((n, 2, h // 32, w // 32), device=ref.device)
        for i, (r, s) in enumerate(zip(refs[::-1], supps[::-1])):
            if i:
                flow = F.interpolate(flow, scale_factor=2.0, mode="bilinear",
                                     align_corners=True) * 2.0
            v = torch.cat([r, flow_warp(s, flow[:, 0], flow[:, 1], "border"),
                           flow], dim=1)
            lvl = getattr(self, f"level{i}")
            for j in range(5):
                v = getattr(lvl, f"conv{j}")(v)
                if j < 4:
                    v = F.relu(v)
            flow = flow + v
        return flow


def second_order_flows(fwd, bwd):
    """(B, T-1, 2, H, W) first-order flows → frame-indexed second-order
    flows (B, T, 2, H, W) of both branches, flow_n2 = flow_n1 +
    warp(flow_n2, flow_n1), zero where a frame has fewer than two
    predecessors in the branch's order."""
    b, tm1, _, h, w = fwd.shape
    t = tm1 + 1
    fwd2 = torch.zeros((b, t, 2, h, w), device=fwd.device)
    bwd2 = torch.zeros_like(fwd2)

    def comp(n1, n2):
        return n1 + flow_warp(n2, n1[:, 0], n1[:, 1])

    for j in range(t):
        if j < t - 2:           # backward branch: frames j+1, j+2 precede j
            bwd2[:, j] = comp(bwd[:, j], bwd[:, j + 1])
        if j > 1:               # forward branch: frames j-1, j-2 precede j
            fwd2[:, j] = comp(fwd[:, j - 1], fwd[:, j - 2])
    return fwd2, bwd2


class Align(Layer):
    """Second-order flow-guided deformable alignment: offsets and masks
    from convs over (cond_n1, feat, cond_n2, flows); offsets =
    mrm·tanh(raw) + the flow of the group's anchor (the first G/2 groups
    anchor on flow 1, the rest on flow 2); masks = sigmoid."""

    record = None   # a list that collects (H, Cin, Cout, G) of each call

    def __init__(self, c, g):
        super().__init__()
        self.offset_conv0 = Conv2d(3 * c + 4, c)
        self.offset_conv1 = Conv2d(c, c)
        self.offset_conv2 = Conv2d(c, c)
        self.offset_out = Conv2d(c, 27 * g)
        self.weight = _param(c, 2 * c, 3, 3)
        self.bias = _param(c)
        self.g = g

    def forward(self, x, cond_n1, feat, cond_n2, f1, f2, mrm):
        h = torch.cat([cond_n1, feat, cond_n2, f1, f2], dim=1)
        for conv in (self.offset_conv0, self.offset_conv1, self.offset_conv2):
            h = F.leaky_relu(conv(h), 0.1)
        out = self.offset_out(h)
        g = self.g
        off = mrm * torch.tanh(out[:, :18 * g])
        n, _, hh, ww = off.shape
        off = off.reshape(n, 2, g // 2, 9, 2, hh, ww)   # anchor, group, tap, (dy, dx)
        anchor = torch.stack([f1.flip(1), f2.flip(1)], 1)   # (N, 2, (dy, dx), H, W)
        off = off + anchor[:, :, None, None]
        off = off.reshape(n, g, 9, 2, hh, ww)
        mask = torch.sigmoid(out[:, 18 * g:]).reshape(n, g, 9, hh, ww)
        return self.deform_conv(x, off, mask)

    def deform_conv(self, x, off, mask):
        """x (N, Cin, H, W); off (N, G, 9, 2, H, W) in pixels as (dy, dx);
        mask (N, G, 9, H, W) → (N, Cout, H, W); 3×3 taps, padding 1."""
        n, cin, h, w = x.shape
        g = self.g
        cout = self.weight.shape[0]
        if self.record is not None:
            self.record.append((h, cin, cout, g))
        ky, kx = torch.meshgrid(torch.arange(3, device=x.device) - 1.0,
                                torch.arange(3, device=x.device) - 1.0,
                                indexing="ij")
        gy, gx = torch.meshgrid(torch.arange(h, device=x.device).float(),
                                torch.arange(w, device=x.device).float(),
                                indexing="ij")
        sy = gy + ky.reshape(9, 1, 1) + off[:, :, :, 0]    # (N, G, 9, H, W)
        sx = gx + kx.reshape(9, 1, 1) + off[:, :, :, 1]
        grid = torch.stack([2 * sx / max(w - 1, 1) - 1,
                            2 * sy / max(h - 1, 1) - 1], dim=-1)
        xv = x.reshape(n * g, cin // g, h, w)
        s = F.grid_sample(xv, grid.reshape(n * g, 9 * h, w, 2),
                          mode="bilinear", padding_mode="zeros",
                          align_corners=True)            # (N·G, Cin/G, 9H, W)
        s = s.reshape(n, g, cin // g, 9, h, w) * mask[:, :, None]
        cols = s.reshape(n, cin * 9, h * w)
        wmat = self.weight.reshape(cout, cin * 9)
        out = torch.matmul(self.q(wmat), self.q(cols))
        return out.reshape(n, cout, h, w) + self.bias[:, None, None]


class Backbone(nn.Module):
    """Input conv + LeakyReLU(0.1) + one residual block x + conv2(relu(conv1 x))."""

    def __init__(self, cin, c):
        super().__init__()
        self.conv_in = Conv2d(cin, c)
        self.block0 = nn.Module()
        self.block0.conv1 = Conv2d(c, c)
        self.block0.conv2 = Conv2d(c, c)

    def forward(self, x):
        x = F.leaky_relu(self.conv_in(x), 0.1)
        return x + self.block0.conv2(F.relu(self.block0.conv1(x)))


class Branch(nn.Module):
    def __init__(self, c, cin, g):
        super().__init__()
        self.deform_align = Align(c, g)
        self.backbone = Backbone(cin, c)


class BasicVSRPP(nn.Module):
    """Backward then forward second-order propagation over the frames of
    each clip; returns hidden + conv_last(reconstruction(hidden, bwd, fwd))."""

    def __init__(self, c, mrm, g):
        super().__init__()
        self.mrm = mrm
        self.backward_1 = Branch(c, 2 * c, g)
        self.forward_1 = Branch(c, 3 * c, g)
        self.reconstruction = Backbone(3 * c, c)
        self.conv_last = Conv2d(c, c, 1)

    def branch(self, p, feats, extra, flow1, flow2, order, weights=None):
        """flow1 / flow2: (B, T, 2, H, W), the branch's first- and
        second-order flow at each frame; ``weights`` (B, T, 1, H, W) gate
        each frame's propagated feature."""
        b, t = feats.shape[:2]
        out = [None] * t
        prop_n1 = prop_n2 = torch.zeros_like(feats[:, 0])
        for i, j in enumerate(order):
            f1, f2 = flow1[:, j], flow2[:, j]
            if i:
                cond_n1 = flow_warp(prop_n1, f1[:, 0], f1[:, 1])
                cond_n2 = flow_warp(prop_n2, f2[:, 0], f2[:, 1])
                prop = p.deform_align(torch.cat([prop_n1, prop_n2], 1),
                                      cond_n1, feats[:, j], cond_n2, f1, f2,
                                      self.mrm)
            else:
                prop = torch.zeros_like(prop_n1)
            inp = [feats[:, j]] + ([] if extra is None else [extra[:, j]])
            prop = prop + p.backbone(torch.cat(inp + [prop], dim=1))
            if weights is not None:
                prop = prop * weights[:, j]
            prop_n1, prop_n2 = prop, prop_n1
            out[j] = prop
        return torch.stack(out, 1)

    def forward(self, hidden, b, flows, weights=None):
        """hidden (B·T, C, H, W); flows (fwd, bwd, fwd2, bwd2) with fwd / bwd
        (B, T-1, 2, H, W) and fwd2 / bwd2 (B, T, 2, H, W); ``weights``
        (B, T, H', W', 1) gate the propagation in both branches (FLAIR's
        background weights, unet.py:489), nearest-resized to H × W."""
        n, c, h, w = hidden.shape
        feats = hidden.reshape(b, n // b, c, h, w)
        fwd, bwd, fwd2, bwd2 = flows
        zero = torch.zeros_like(fwd[:, :1])
        t = n // b
        if weights is not None:
            weights = F.interpolate(
                weights.reshape(n, *weights.shape[2:]).permute(0, 3, 1, 2),
                size=(h, w), mode="nearest").reshape(b, t, 1, h, w)
        back = self.branch(self.backward_1, feats, None,
                           torch.cat([bwd, zero], 1), bwd2,
                           range(t - 1, -1, -1), weights)
        forw = self.branch(self.forward_1, feats, back,
                           torch.cat([zero, fwd], 1), fwd2, range(t),
                           weights)
        hr = self.reconstruction(torch.cat([feats, back, forw], 2).reshape(
            n, 3 * c, h, w))
        return hidden + self.conv_last(hr)
