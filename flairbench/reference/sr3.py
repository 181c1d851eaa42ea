"""The x8 denoiser, plain float32: FLAIR's SR3-style video UNet
(wustl-cig/FLAIR sr3.py:317), continuous noise-level conditioning, per
level a resnet block, a (3, 1, 1) temporal ResBlock, temporal attention
at ``attn_res`` and BasicVSR++ at ``vsrpp_res``, each temporal module
behind a sigmoid gate of the embedding. Spatial self-attention is off in
every FLAIR configuration and is not written here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import (Conv2d, Dense, Gate, GroupNorm, ResBlock, TemporalAttention,
                 noise_level_embedding)
from .vsrpp import BasicVSRPP, SPyNet, second_order_flows


class SR3Block(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm = GroupNorm(cin, groups)
        self.conv = Conv2d(cin, cout)

    def forward(self, x, b):
        return self.conv(F.silu(self.norm(x, b)))


class SR3ResnetBlock(nn.Module):
    def __init__(self, cin, cout, emb, groups):
        super().__init__()
        self.block1 = SR3Block(cin, cout, groups)
        self.noise_proj = Dense(emb, cout)
        self.block2 = SR3Block(cout, cout, groups)
        self.res_conv = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb, b):
        h = self.block1(x, b) + self.noise_proj(emb)[:, :, None, None]
        h = self.block2(h, b)
        return h + (x if self.res_conv is None else self.res_conv(x))


class LevelBlock(nn.Module):
    def __init__(self, cin, cout, emb, groups, *, temporal, vsrpp, frames,
                 head_dim, deform_groups):
        super().__init__()
        self.res_block = SR3ResnetBlock(cin, cout, emb, groups)
        self.conv_3d = ResBlock(cout, cout, emb, dims=3, kernel=(3, 1, 1))
        self.conv_3d_gate = Gate(cout, emb)
        if temporal:
            self.temp_attn = TemporalAttention(cout, frames, head_dim)
            self.temp_attn_gate = Gate(cout, emb)
        if vsrpp:
            self.vsrpp = BasicVSRPP(cout, 5.0, deform_groups)
            self.vsrpp_gate = Gate(cout, emb)

    def forward(self, x, emb, b, flows, weights=None):
        x = self.res_block(x, emb, b)
        x = self.conv_3d_gate(x, self.conv_3d(x, emb, b), emb)
        if hasattr(self, "temp_attn"):
            x = self.temp_attn_gate(x, self.temp_attn(x, b), emb)
        if hasattr(self, "vsrpp"):
            x = self.vsrpp_gate(x, self.vsrpp(x, b, flows, weights), emb)
        return x


class BicubicUNet(nn.Module):
    """Keyword arguments as the configuration files give them."""

    CONDITIONING = "noise_level"
    FLOAT32_PARTS = ("mlp_in", "mlp_out", "spynet", "final_norm",
                     "final_conv")

    def __init__(self, in_channel=6, out_channel=3, inner_channel=64,
                 norm_groups=16, channel_mults=(1, 2, 4, 8, 16),
                 attn_res=(64, 32), vsrpp_res=(512, 256), spatial_attn=False,
                 temporal_attn=True, res_blocks=1, image_size=512,
                 cross_frame_module=True, num_frames=7, head_dim=64,
                 deform_groups=16):
        super().__init__()
        if spatial_attn or not (temporal_attn and cross_frame_module):
            raise ValueError("reference: FLAIR's temporal form only")
        inner = inner_channel
        self.inner, self.mults, self.res_blocks = inner, channel_mults, res_blocks
        self.image_size, self.vsrpp_res = image_size, tuple(vsrpp_res)
        kw = dict(frames=num_frames, head_dim=head_dim,
                  deform_groups=deform_groups)
        self.mlp_in = Dense(inner, inner * 4)
        self.mlp_out = Dense(inner * 4, inner)
        self.spynet = SPyNet()
        self.conv_in = Conv2d(in_channel, inner)
        feat_ch, ch, res, li = [inner], inner, image_size, 0
        for ind, mult in enumerate(channel_mults):
            for _ in range(res_blocks):
                setattr(self, f"down_{li}", LevelBlock(
                    ch, inner * mult, inner, norm_groups,
                    temporal=res in attn_res, vsrpp=res in vsrpp_res, **kw))
                ch = inner * mult
                feat_ch.append(ch)
                li += 1
            if ind != len(channel_mults) - 1:
                setattr(self, f"downsample_{ind}",
                        Conv2d(ch, ch, 3, stride=2, padding=1))
                feat_ch.append(ch)
                res //= 2
        for mi in range(2):
            setattr(self, f"mid_{mi}", LevelBlock(
                ch, ch, inner, norm_groups, temporal=True, vsrpp=False, **kw))
        li = 0
        for ind in reversed(range(len(channel_mults))):
            for _ in range(res_blocks + 1):
                c = inner * channel_mults[ind]
                setattr(self, f"up_{li}", LevelBlock(
                    ch + feat_ch.pop(), c, inner, norm_groups,
                    temporal=res in attn_res, vsrpp=res in vsrpp_res, **kw))
                ch = c
                li += 1
            if ind >= 1:
                setattr(self, f"upsample_{ind}", Conv2d(ch, ch))
                res *= 2
        self.final_norm = GroupNorm(ch, norm_groups)
        self.final_conv = Conv2d(ch, out_channel)

    def flows(self, rnn_input):
        """{res: (fwd, bwd, fwd2, bwd2)} of a (B, T, H, W, 3) clip in
        [-1, 1]: SPyNet on the [0, 1] frames, downsized to each VSR++
        resolution by antialiased bilinear resizing."""
        b, t, h = rnn_input.shape[:3]
        lq = ((rnn_input + 1) / 2).clamp(0, 1).permute(0, 1, 4, 2, 3)
        out = {}
        for res in self.vsrpp_res:
            v = lq.reshape(b * t, 3, h, h)
            if res != h:
                v = F.interpolate(v, size=(res, res), mode="bilinear",
                                  align_corners=False, antialias=True)
            v = v.reshape(b, t, 3, res, res)
            l1 = v[:, :-1].reshape(-1, 3, res, res)
            l2 = v[:, 1:].reshape(-1, 3, res, res)
            fwd = self.spynet(l2, l1).reshape(b, t - 1, 2, res, res)
            bwd = self.spynet(l1, l2).reshape(b, t - 1, 2, res, res)
            out[res] = (fwd, bwd) + second_order_flows(fwd, bwd)
        return out

    def forward(self, x, noise_level, low_res, flows, weights=None):
        """x, low_res (B, T, H, W, 3); noise_level (B, T) → eps (B, T, H, W,
        3); ``weights`` (B, T, H, W, 1): the VSR++ gating of every level
        (video_sample.py:427-444), none by default."""
        b, t, hh, ww = x.shape[:4]
        n = b * t
        emb = noise_level_embedding(noise_level.reshape(n), self.inner)
        emb = self.mlp_out(F.silu(self.mlp_in(emb)))
        h = torch.cat([low_res, x], -1).reshape(n, hh, ww, -1).permute(
            0, 3, 1, 2)
        h = self.conv_in(h)
        feats, res, li = [h], self.image_size, 0
        for ind in range(len(self.mults)):
            for _ in range(self.res_blocks):
                h = getattr(self, f"down_{li}")(h, emb, b, flows.get(res),
                                                weights)
                feats.append(h)
                li += 1
            if ind != len(self.mults) - 1:
                h = getattr(self, f"downsample_{ind}")(h)
                feats.append(h)
                res //= 2
        for mi in range(2):
            h = getattr(self, f"mid_{mi}")(h, emb, b, None)
        li = 0
        for ind in reversed(range(len(self.mults))):
            for _ in range(self.res_blocks + 1):
                h = getattr(self, f"up_{li}")(torch.cat([h, feats.pop()], 1),
                                              emb, b, flows.get(res), weights)
                li += 1
            if ind >= 1:
                h = getattr(self, f"upsample_{ind}")(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
                res *= 2
        out = self.final_conv(F.silu(self.final_norm(h, b)))
        return out.permute(0, 2, 3, 1).reshape(b, t, hh, ww, -1)
