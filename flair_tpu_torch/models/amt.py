"""AMT all-pairs-correlation frame interpolator.

Counterpart of ``flair_tpu/models/amt.py`` (reference amt.py:44-236 and
amt_blocks/{raft,feat_enc,ifrnet,multi_flow}.py): a RAFT bidirectional
correlation volume over 1/8-resolution features, coarse-to-fine decoders
with correlation-lookup update blocks, and a multi-flow combination. The
training runner densifies temporally decimated clips with it
(``make_interpolator``; train_util.py:231-250).

The correlation is a plain float32 matmul and its lookup ``grid_sample``,
as the JAX package computes them outside any Pallas kernel. ``UpConv`` is
flax's ``ConvTranspose`` ((4, 4), stride 2, SAME), which correlates an
unflipped kernel: the port keeps torch's ``ConvTranspose2d`` layout
(in, out, 4, 4) with the taps reversed, and ``utils.convert.from_flax``
flips them across.

``AMT.forward`` takes (B, H, W, 3) frames in [0, 1], as the JAX module
does; inside, NCHW channels_last.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp, grid_sample
from .common import Conv2d, _lecun_, channels_last, leaky_relu, nchw, nhwc
from .registry import register_model


def _resize2(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) to ``int(size·scale)``."""
    h, w = x.shape[2], x.shape[3]
    return channels_last(nchw(resize_bilinear(
        nhwc(x), (int(h * scale), int(w * scale)))))


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """flow_utils.warp: bilinear, border padding, align_corners=True."""
    return flow_warp(img, flow, padding_mode="border", align_corners=True)


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Affine-free instance norm, biased variance, eps 1e-5."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class PReLU(nn.Module):
    """Per-channel PReLU, slopes initialised at 0.25 (named ``prelu``, as
    the flax leaf)."""

    def __init__(self, channels: int):
        super().__init__()
        self.prelu = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return F.prelu(x, self.prelu.to(x.dtype))


class ConvPReLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, features, kernel, stride, dtype=dtype)
        self.act = PReLU(features)

    def forward(self, x):
        return self.act(self.conv(x))


class ConvTranspose2d(nn.Module):
    """torch ``ConvTranspose2d(in, out, 4, stride=2, padding=1)``: flax's
    ConvTranspose((4, 4), (2, 2), "SAME") output size (2H, 2W) at every
    size. ``weight`` (in, out, 4, 4)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, 4, 4))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        _lecun_(self.weight.data, in_ch * 16)

    def forward(self, x):
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=2, padding=1)


class UpConv(nn.Module):
    """2× transposed conv (torch ConvTranspose2d(4, 2, 1) geometry)."""

    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__()
        self.deconv = ConvTranspose2d(in_ch, features, dtype)

    def forward(self, x):
        return self.deconv(x)


class IFRResBlock(nn.Module):
    """ifrnet.py ResBlock with side-channel mixing."""

    def __init__(self, channels: int, side_channels: int,
                 dtype=torch.float32):
        super().__init__()
        c, s = channels, side_channels
        self.side = s
        self.conv1 = ConvPReLU(c, c, 3, dtype=dtype)
        self.conv2 = ConvPReLU(s, s, 3, dtype=dtype)
        self.conv3 = ConvPReLU(c, c, 3, dtype=dtype)
        self.conv4 = ConvPReLU(s, s, 3, dtype=dtype)
        self.conv5 = Conv2d(c, c, 3, dtype=dtype)
        self.prelu = PReLU(c)

    def forward(self, x):
        s = self.side
        out = self.conv1(x)
        side = self.conv2(out[:, -s:])
        out = self.conv3(torch.cat([out[:, :-s], side], dim=1))
        side = self.conv4(out[:, -s:])
        out = self.conv5(torch.cat([out[:, :-s], side], dim=1))
        return self.prelu(x + out)


class FeatResBlock(nn.Module):
    """feat_enc.py ResidualBlock, instance-norm variant; the 1×1
    downsample shortcut is normed too (feat_enc.py:100-104)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, padding=1,
                            dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, dtype=dtype)
        if stride != 1 or in_ch != features:
            self.downsample = Conv2d(in_ch, features, 1, stride, padding=0,
                                     dtype=dtype)

    def forward(self, x):
        h = F.relu(_instance_norm(self.conv1(x)))
        h = F.relu(_instance_norm(self.conv2(h)))
        if hasattr(self, "downsample"):
            x = _instance_norm(self.downsample(x))
        return F.relu(x + h)


class LargeEncoder(nn.Module):
    """feat_enc.py:267-345: 1/8-resolution correlation features."""

    STAGES = ((64, 1), (112, 2), (160, 2), (160, 1))

    def __init__(self, output_dim: int = 128, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, dtype=dtype)
        ci = 64
        for i, (dim, stride) in enumerate(self.STAGES):
            setattr(self, f"layer{i}_0", FeatResBlock(ci, dim, stride, dtype))
            setattr(self, f"layer{i}_1", FeatResBlock(dim, dim, 1, dtype))
            ci = dim
        self.conv2 = Conv2d(ci, output_dim, 1, dtype=dtype)

    def forward(self, x):
        h = F.relu(_instance_norm(self.conv1(x)))
        for i in range(len(self.STAGES)):
            h = getattr(self, f"layer{i}_1")(getattr(self, f"layer{i}_0")(h))
        return self.conv2(h)


class IFREncoder(nn.Module):
    """ifrnet.py Encoder: a 4-level strided pyramid."""

    def __init__(self, channels: Sequence[int], large: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.levels = len(channels)
        ci = 3
        for idx, ch in enumerate(channels):
            k = 7 if large and idx == 0 else 3
            setattr(self, f"pyr{idx}_0", ConvPReLU(ci, ch, k, 2, dtype))
            setattr(self, f"pyr{idx}_1", ConvPReLU(ch, ch, 3, 1, dtype))
            ci = ch

    def forward(self, x):
        fs = []
        for idx in range(self.levels):
            x = getattr(self, f"pyr{idx}_1")(getattr(self, f"pyr{idx}_0")(x))
            fs.append(x)
        return fs


# ---------------------------------------------------------------------------
# Bidirectional correlation pyramid (raft.py:147-216)
# ---------------------------------------------------------------------------


class BidirCorr:
    """All-pairs correlation of two (B, D, h, w) feature maps, pooled over
    the target dims into ``num_levels`` levels, both ways."""

    def __init__(self, fmap0: torch.Tensor, fmap1: torch.Tensor,
                 num_levels: int = 4, radius: int = 3):
        self.num_levels = num_levels
        self.radius = radius
        b, d, h, w = fmap0.shape
        f0 = fmap0.float().reshape(b, d, h * w).transpose(1, 2)
        f1 = fmap1.float().reshape(b, d, h * w)
        corr = torch.matmul(f0, f1) / math.sqrt(d)          # (B, N, M)
        # pyramids over the target dims, (B·N, 1, h', w') a level, 2× average
        # pools (floor on odd sizes)
        c = corr.reshape(b * h * w, 1, h, w)
        ct = corr.transpose(1, 2).reshape(b * h * w, 1, h, w)
        self.pyr, self.pyr_t = [c], [ct]
        for _ in range(num_levels - 1):
            self.pyr.append(F.avg_pool2d(self.pyr[-1], 2, 2))
            self.pyr_t.append(F.avg_pool2d(self.pyr_t[-1], 2, 2))
        self.shape = (b, h, w)

    def lookup(self, coords0: torch.Tensor, coords1: torch.Tensor):
        """coords* (B, h, w, 2) pixel coordinates, (x, y). Returns (corr,
        corr_T), each (B, levels·(2r+1)², h, w)."""
        b, h, w = self.shape
        r = self.radius
        n = 2 * r + 1
        dy, dx = np.meshgrid(np.linspace(-r, r, n), np.linspace(-r, r, n),
                             indexing="ij")
        # RAFT adds its (dy, dx)-ordered window to (x, y)-ordered centroids
        # (raft.py:180-186), so the x offset runs along the window's FIRST
        # axis: kept, or every off-centre tap transposes
        delta = torch.as_tensor(np.stack([dy, dx], -1).reshape(1, n, n, 2),
                                dtype=torch.float32, device=coords0.device)

        def one_dir(pyr, coords):
            outs = []
            cc = coords.float().reshape(b * h * w, 1, 1, 2)
            for i, cp in enumerate(pyr):
                ch_, cw_ = cp.shape[2], cp.shape[3]
                if ch_ <= 1 or cw_ <= 1:
                    samp = cp[:, :, :1, :1].expand(-1, 1, n, n)
                else:
                    pts = cc / (2 ** i) + delta            # (B·N, n, n, 2)
                    gx = 2 * pts[..., 0] / (cw_ - 1) - 1
                    gy = 2 * pts[..., 1] / (ch_ - 1) - 1
                    samp = grid_sample(cp, torch.stack([gx, gy], -1),
                                       align_corners=True)
                outs.append(samp.reshape(b, h, w, n * n))
            return channels_last(nchw(torch.cat(outs, dim=-1)))

        return one_dir(self.pyr, coords0), one_dir(self.pyr_t, coords1)


# ---------------------------------------------------------------------------
# Decoders and update blocks
# ---------------------------------------------------------------------------


class InitDecoder(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, skip_ch: int,
                 dtype=torch.float32):
        super().__init__()
        c2 = 2 * in_ch
        self.conv_in = ConvPReLU(c2 + 1, c2, 3, dtype=dtype)
        self.res = IFRResBlock(c2, skip_ch, dtype)
        self.up = UpConv(c2, out_ch + 4, dtype)

    def forward(self, f0, f1, embt):
        b, _, h, w = f0.shape
        e = embt.reshape(b, 1, 1, 1).expand(b, 1, h, w).to(f0.dtype)
        x = self.conv_in(torch.cat([f0, f1, e], dim=1))
        x = self.up(self.res(x))
        return x[:, :2], x[:, 2:4], x[:, 4:]


class IntermediateDecoder(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, skip_ch: int,
                 dtype=torch.float32):
        super().__init__()
        c3 = 3 * in_ch
        self.conv_in = ConvPReLU(c3 + 4, c3, 3, dtype=dtype)
        self.res = IFRResBlock(c3, skip_ch, dtype)
        self.up = UpConv(c3, out_ch + 4, dtype)

    def forward(self, ft, f0, f1, flow0, flow1):
        x = torch.cat([ft, _warp(f0, flow0), _warp(f1, flow1), flow0, flow1],
                      dim=1)
        x = self.up(self.res(self.conv_in(x)))
        nf0 = x[:, :2] + 2.0 * _resize2(flow0, 2.0)
        nf1 = x[:, 2:4] + 2.0 * _resize2(flow1, 2.0)
        return nf0, nf1, x[:, 4:]


class MultiFlowDecoder(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, num_flows: int = 5,
                 dtype=torch.float32):
        super().__init__()
        c3 = 3 * in_ch
        self.num_flows = num_flows
        self.conv_in = ConvPReLU(c3 + 4, c3, 3, dtype=dtype)
        self.res = IFRResBlock(c3, skip_ch, dtype)
        self.up = UpConv(c3, 8 * num_flows, dtype)

    def forward(self, ft, f0, f1, flow0, flow1):
        n = self.num_flows
        x = torch.cat([ft, _warp(f0, flow0), _warp(f1, flow1), flow0, flow1],
                      dim=1)
        x = self.up(self.res(self.conv_in(x)))
        d0, d1, mask, img_res = torch.split(x, [2 * n, 2 * n, n, 3 * n],
                                            dim=1)
        f0u = (2.0 * _resize2(flow0, 2.0)).repeat(1, n, 1, 1)
        f1u = (2.0 * _resize2(flow1, 2.0)).repeat(1, n, 1, 1)
        return d0 + f0u, d1 + f1u, torch.sigmoid(mask), img_res


class BasicUpdateBlock(nn.Module):
    """raft.py:92-143. ``corr_ch``: channels of the correlation input."""

    def __init__(self, cdim: int, corr_ch: int, hidden_dim: int = 192,
                 flow_dim: int = 64, corr_dim: int = 256,
                 corr_dim2: int = 192, fc_dim: int = 188,
                 scale_factor: float | None = None, dtype=torch.float32):
        super().__init__()
        self.scale_factor = scale_factor

        def conv(ci, co, k):
            return Conv2d(ci, co, k, dtype=dtype)

        self.convc1 = conv(corr_ch, corr_dim, 1)
        self.convc2 = conv(corr_dim, corr_dim2, 3)
        self.convf1 = conv(4, flow_dim * 2, 7)
        self.convf2 = conv(flow_dim * 2, flow_dim, 3)
        self.conv = conv(corr_dim2 + flow_dim, fc_dim, 3)
        self.gru1 = conv(fc_dim + 4 + cdim, hidden_dim, 3)
        self.gru2 = conv(hidden_dim, hidden_dim, 3)
        self.feat1 = conv(hidden_dim, hidden_dim, 3)
        self.feat2 = conv(hidden_dim, cdim, 3)
        self.flow1 = conv(hidden_dim, hidden_dim, 3)
        self.flow2 = conv(hidden_dim, 4, 3)

    def forward(self, net, flow, corr):
        sf = self.scale_factor
        if sf is not None:
            net = _resize2(net, 1 / sf)
        cor = leaky_relu(self.convc1(corr), 0.1)
        cor = leaky_relu(self.convc2(cor), 0.1)
        flo = leaky_relu(self.convf1(flow), 0.1)
        flo = leaky_relu(self.convf2(flo), 0.1)
        inp = leaky_relu(self.conv(torch.cat([cor, flo], dim=1)), 0.1)
        inp = torch.cat([inp, flow, net], dim=1)
        out = self.gru2(leaky_relu(self.gru1(inp), 0.1))
        dn = self.feat2(leaky_relu(self.feat1(out), 0.1))
        df = self.flow2(leaky_relu(self.flow1(out), 0.1))
        if sf is not None:
            dn = _resize2(dn, sf)
            df = sf * _resize2(df, sf)
        return dn, df


@register_model("amt")
class AMT(nn.Module):
    """Single-t interpolation core (amt.py:113-225 ``_forward``); the
    defaults are AMT-G. :func:`interpolate` runs it frame by frame."""

    def __init__(self, corr_radius: int = 3, corr_lvls: int = 4,
                 num_flows: int = 5,
                 channels: Sequence[int] = (84, 96, 112, 128),
                 skip_channels: int = 84, dtype=torch.float32):
        super().__init__()
        ch = tuple(channels)
        self.corr_radius = corr_radius
        self.corr_lvls = corr_lvls
        self.num_flows = num_flows
        corr_ch = 2 * corr_lvls * (2 * corr_radius + 1) ** 2
        self.feat_encoder = LargeEncoder(128, dtype)
        self.encoder = IFREncoder(ch, large=True, dtype=dtype)
        self.decoder4 = InitDecoder(ch[3], ch[2], skip_channels, dtype)
        self.update4 = BasicUpdateBlock(ch[2], corr_ch, dtype=dtype)
        self.decoder3 = IntermediateDecoder(ch[2], ch[1], skip_channels,
                                            dtype)
        self.update3_low = BasicUpdateBlock(ch[1], corr_ch, scale_factor=2.0,
                                            dtype=dtype)
        self.update3_high = BasicUpdateBlock(ch[1], corr_ch, dtype=dtype)
        self.decoder2 = IntermediateDecoder(ch[1], ch[0], skip_channels,
                                            dtype)
        self.update2_low = BasicUpdateBlock(ch[0], corr_ch, scale_factor=4.0,
                                            dtype=dtype)
        self.update2_high = BasicUpdateBlock(ch[0], corr_ch, dtype=dtype)
        self.decoder1 = MultiFlowDecoder(ch[0], skip_channels, num_flows,
                                         dtype)
        self.comb0 = ConvPReLU(3 * num_flows, 6 * num_flows, 7, dtype=dtype)
        self.comb1 = Conv2d(6 * num_flows, 3, 7, dtype=dtype)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                embt: torch.Tensor) -> torch.Tensor:
        """img0 / img1 (B, H, W, 3) in [0, 1]; embt (B,) in (0, 1).
        Returns (B, H, W, 3) in [0, 1]."""
        mean_ = torch.cat([img0, img1], dim=2).mean(dim=(1, 2, 3),
                                                    keepdim=True)
        img0 = channels_last(nchw(img0 - mean_))
        img1 = channels_last(nchw(img1 - mean_))
        b, _, h, w = img0.shape

        fmap0 = self.feat_encoder(img0)
        fmap1 = self.feat_encoder(img1)
        corr_fn = BidirCorr(fmap0, fmap1, self.corr_lvls, self.corr_radius)
        gy, gx = torch.meshgrid(
            torch.arange(h // 8, dtype=torch.float32, device=img0.device),
            torch.arange(w // 8, dtype=torch.float32, device=img0.device),
            indexing="ij")
        coord = torch.stack([gx, gy], -1)[None]        # (1, h/8, w/8, 2)

        f0_1, f0_2, f0_3, f0_4 = self.encoder(img0)
        f1_1, f1_2, f1_3, f1_4 = self.encoder(img1)
        t1s = 1.0 / embt.reshape(b, 1, 1, 1)
        t0s = 1.0 / (1.0 - embt.reshape(b, 1, 1, 1))

        def corr_lookup(flow0, flow1, downsample):
            if downsample != 1:
                inv = 1.0 / downsample
                flow0 = inv * _resize2(flow0, inv)
                flow1 = inv * _resize2(flow1, inv)
            c0, c1 = corr_fn.lookup(coord + nhwc(flow1) * t1s,
                                    coord + nhwc(flow0) * t0s)
            return (torch.cat([c0, c1], dim=1),
                    torch.cat([flow0, flow1], dim=1))

        # decoder 4 (1/16 → 1/8)
        up_f0_4, up_f1_4, ft_3 = self.decoder4(f0_4, f1_4, embt)
        corr4, flow4 = corr_lookup(up_f0_4, up_f1_4, 1)
        dft, dfl = self.update4(ft_3, flow4, corr4)
        up_f0_4 = up_f0_4 + dfl[:, :2]
        up_f1_4 = up_f1_4 + dfl[:, 2:]
        ft_3 = ft_3 + dft

        # decoder 3 (1/8 → 1/4)
        up_f0_3, up_f1_3, ft_2 = self.decoder3(ft_3, f0_3, f1_3, up_f0_4,
                                               up_f1_4)
        corr3, flow3 = corr_lookup(up_f0_3, up_f1_3, 2)
        dft, dfl = self.update3_low(ft_2, flow3, corr3)
        up_f0_3 = up_f0_3 + dfl[:, :2]
        up_f1_3 = up_f1_3 + dfl[:, 2:]
        ft_2 = ft_2 + dft
        dft, dfl = self.update3_high(
            ft_2, torch.cat([up_f0_3, up_f1_3], dim=1), _resize2(corr3, 2.0))
        ft_2 = ft_2 + dft
        up_f0_3 = up_f0_3 + dfl[:, :2]
        up_f1_3 = up_f1_3 + dfl[:, 2:]

        # decoder 2 (1/4 → 1/2)
        up_f0_2, up_f1_2, ft_1 = self.decoder2(ft_2, f0_2, f1_2, up_f0_3,
                                               up_f1_3)
        corr2, flow2 = corr_lookup(up_f0_2, up_f1_2, 4)
        dft, dfl = self.update2_low(ft_1, flow2, corr2)
        up_f0_2 = up_f0_2 + dfl[:, :2]
        up_f1_2 = up_f1_2 + dfl[:, 2:]
        ft_1 = ft_1 + dft
        dft, dfl = self.update2_high(
            ft_1, torch.cat([up_f0_2, up_f1_2], dim=1), _resize2(corr2, 4.0))
        ft_1 = ft_1 + dft
        up_f0_2 = up_f0_2 + dfl[:, :2]
        up_f1_2 = up_f1_2 + dfl[:, 2:]

        # decoder 1 (1/2 → 1), multi-flow
        up_f0_1, up_f1_1, mask, img_res = self.decoder1(
            ft_1, f0_1, f1_1, up_f0_2, up_f1_2)

        # multi-flow combination (multi_flow.py:12-56): flow k of a pixel is
        # channels (2k, 2k + 1), its residue channels 3k..3k + 2
        n = self.num_flows

        def per_flow(v, c):      # (B, n·c, H, W) → (B·n, c, H, W)
            return v.reshape(b * n, c, h, w)

        def tile(v):             # (B, C, ...) → (B·n, C, ...)
            return v[:, None].expand(b, n, *v.shape[1:]).reshape(
                b * n, *v.shape[1:])

        mkn = per_flow(mask, 1)
        warps = (mkn * _warp(tile(img0), per_flow(up_f0_1, 2))
                 + (1 - mkn) * _warp(tile(img1), per_flow(up_f1_1, 2))
                 + tile(nchw(mean_)) + per_flow(img_res, 3))
        warps = warps.reshape(b, n, 3, h, w)
        comb = self.comb1(self.comb0(channels_last(
            warps.reshape(b, n * 3, h, w))))
        pred = warps.mean(dim=1) + comb
        return nhwc(torch.clamp(pred, 0, 1))


def interpolate(model: AMT, frame0: torch.Tensor, frame1: torch.Tensor,
                factor: int) -> torch.Tensor:
    """The multi-frame loop (amt.py:227-236): frames (B, H, W, 3) in [-1, 1],
    edge-padded to a multiple of 16, one ``model`` call per intermediate
    frame; returns (B, factor − 1, H, W, 3) in [-1, 1]."""
    i0 = (frame0 + 1) / 2
    i1 = (frame1 + 1) / 2
    b, h, w, _ = i0.shape
    ph, pw = (-h) % 16, (-w) % 16
    top, left = ph // 2, pw // 2
    pad = (left, pw - left, top, ph - top)
    i0p = nhwc(F.pad(nchw(i0), pad, mode="replicate"))
    i1p = nhwc(F.pad(nchw(i1), pad, mode="replicate"))
    outs = []
    for i in range(1, factor):
        embt = torch.full((b,), i / factor, dtype=torch.float32,
                          device=i0.device)
        pred = model(i0p, i1p, embt)
        outs.append(pred[:, top:top + h, left:left + w])
    return torch.stack(outs, dim=1) * 2 - 1


def make_interpolator(model: AMT) -> Callable:
    """``TrainRunner``'s ``interpolate(f0, f1, skip)`` bound to ``model``
    (the JAX ``TrainRunner(amt=(model, params))``): eval mode and
    ``no_grad``, so the densified conditioning carries no graph into AMT
    and AMT's parameters get no gradient. ``model`` lives on the runner's
    device and stays out of its optimizer and EMA."""
    model.eval()

    def interp(f0, f1, skip):
        with torch.no_grad():
            return interpolate(model, f0, f1, skip)

    return interp
