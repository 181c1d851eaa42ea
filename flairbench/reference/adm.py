"""The gaussian / jpeg denoiser, plain float32: FLAIR's ADM video UNet
(wustl-cig/FLAIR unet_new.py:901) with learned-range variance (6 output
channels), scale-shift norm, ResBlock up / down sampling, spatial
attention at ``attention_resolutions`` and in the bottleneck, temporal
attention and 3×3×3 temporal ResBlocks, and BasicVSR++ (M = 10) at
``rnn_resolutions``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import (AttentionBlock, Conv2d, Dense, GroupNorm, ResBlock,
                 TemporalAttention, timestep_embedding)
from .vsrpp import BasicVSRPP, SPyNet, second_order_flows


class BlurUNet(nn.Module):
    """Keyword arguments as the configuration files give them."""

    CONDITIONING = "timestep"
    FLOAT32_PARTS = ("time_embed_0", "time_embed_1", "spynet", "out_norm",
                     "out_conv")

    def __init__(self, image_size=512, in_channels=6, model_channels=128,
                 out_channels=6, num_res_blocks=2,
                 attention_resolutions=(16, 32, 64), rnn_resolutions=(1, 2),
                 channel_mult=(0.5, 1, 1, 2, 2, 4, 4), num_heads=1,
                 num_head_channels=64, use_scale_shift_norm=True,
                 temporal_frames=5, deform_groups=16):
        super().__init__()
        if num_head_channels == -1 or not use_scale_shift_norm:
            raise ValueError("reference: FLAIR's head-size form only")
        mc, emb = model_channels, 4 * model_channels
        self.mc, self.nrb, self.mult = mc, num_res_blocks, channel_mult
        self.attn_ds, self.rnn_ds = tuple(attention_resolutions), tuple(
            rnn_resolutions)
        self.image_size = image_size
        hc = num_head_channels

        def res(cin, cout, **kw):
            return ResBlock(cin, cout, emb, scale_shift=True, **kw)

        def stack(base, c, ds):
            setattr(self, base + "_res3d", res(c, c, dims=3))
            if ds in self.attn_ds:
                setattr(self, base + "_attn", AttentionBlock(c, hc))
                setattr(self, base + "_attn_temporal",
                        TemporalAttention(c, temporal_frames, hc))
            if ds in self.rnn_ds:
                setattr(self, base + "_vsrpp",
                        BasicVSRPP(c, 10.0, deform_groups))

        self.time_embed_0 = Dense(mc, emb)
        self.time_embed_1 = Dense(emb, emb)
        self.spynet = SPyNet()
        ch = int(channel_mult[0] * mc)
        self.conv_in = Conv2d(in_channels, ch)
        hs, ds, last = [ch], 1, len(channel_mult) - 1
        for level, m in enumerate(channel_mult):
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res", res(ch, int(m * mc)))
                ch = int(m * mc)
                stack(f"in_{level}_{i}", ch, ds)
                hs.append(ch)
            if level != last:
                setattr(self, f"in_{level}_down", res(ch, ch, down=True))
                hs.append(ch)
                ds *= 2
        self.mid_res1 = res(ch, ch)
        self.mid_res3d_1 = res(ch, ch, dims=3)
        self.mid_attn_temporal = TemporalAttention(ch, temporal_frames, hc)
        self.mid_res3d_2 = res(ch, ch, dims=3)
        self.mid_attn = AttentionBlock(ch, hc, emb_dim=emb)
        self.mid_res2 = res(ch, ch)
        for level, m in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                c = int(m * mc)
                setattr(self, f"out_{level}_{i}_res", res(ch + hs.pop(), c))
                ch = c
                stack(f"out_{level}_{i}", c, ds)
                if level and i == num_res_blocks:
                    setattr(self, f"out_{level}_up", res(c, c, up=True))
                    ds //= 2
        self.out_norm = GroupNorm(ch)
        self.out_conv = Conv2d(ch, out_channels)

    def flows(self, rnn_input):
        """{res: (fwd, bwd, fwd2, bwd2)} of a (B, T, H, W, 3) clip in
        [-1, 1]: resized to each VSR++ resolution by plain bicubic
        resizing, then mapped to [0, 1] and clipped, then SPyNet."""
        b, t, h = rnn_input.shape[:3]
        out = {}
        for s in self.rnn_ds:
            res = self.image_size // s
            v = rnn_input.permute(0, 1, 4, 2, 3).reshape(b * t, 3, h, h)
            if res != h:
                v = F.interpolate(v, size=(res, res), mode="bicubic",
                                  align_corners=False)
            v = ((v + 1) / 2).clamp(0, 1).reshape(b, t, 3, res, res)
            l1 = v[:, :-1].reshape(-1, 3, res, res)
            l2 = v[:, 1:].reshape(-1, 3, res, res)
            fwd = self.spynet(l2, l1).reshape(b, t - 1, 2, res, res)
            bwd = self.spynet(l1, l2).reshape(b, t - 1, 2, res, res)
            out[res] = (fwd, bwd) + second_order_flows(fwd, bwd)
        return out

    def forward(self, x, timesteps, low_res, flows):
        """x, low_res (B, T, H, W, 3); timesteps (B, T) original-schedule
        indices → (B, T, H, W, 6): eps and the variance fractions."""
        b, t, hh, ww = x.shape[:4]
        n = b * t
        emb = timestep_embedding(timesteps.reshape(n), self.mc)
        emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))

        def after_res(h, name, ds):
            h = getattr(self, name + "_res3d")(h, emb, b)
            if ds in self.attn_ds:
                h = getattr(self, name + "_attn")(h, b)
                h = getattr(self, name + "_attn_temporal")(h, b)
            if ds in self.rnn_ds:
                h = getattr(self, name + "_vsrpp")(h, b, flows[h.shape[2]])
            return h

        h = torch.cat([x, low_res], -1).reshape(n, hh, ww, -1).permute(
            0, 3, 1, 2)
        h = self.conv_in(h)
        hs, ds, last = [h], 1, len(self.mult) - 1
        for level in range(len(self.mult)):
            for i in range(self.nrb):
                h = getattr(self, f"in_{level}_{i}_res")(h, emb, b)
                h = after_res(h, f"in_{level}_{i}", ds)
                hs.append(h)
            if level != last:
                h = getattr(self, f"in_{level}_down")(h, emb, b)
                hs.append(h)
                ds *= 2
        h = self.mid_res1(h, emb, b)
        h = self.mid_res3d_1(h, emb, b)
        h = self.mid_attn(h, b, emb)
        h = self.mid_attn_temporal(h, b)
        h = self.mid_res2(h, emb, b)
        h = self.mid_res3d_2(h, emb, b)
        for level in reversed(range(len(self.mult))):
            for i in range(self.nrb + 1):
                h = getattr(self, f"out_{level}_{i}_res")(
                    torch.cat([h, hs.pop()], 1), emb, b)
                h = after_res(h, f"out_{level}_{i}", ds)
                if level and i == self.nrb:
                    h = getattr(self, f"out_{level}_up")(h, emb, b)
                    ds //= 2
        out = self.out_conv(F.silu(self.out_norm(h, b)))
        return out.permute(0, 2, 3, 1).reshape(b, t, hh, ww, -1)
