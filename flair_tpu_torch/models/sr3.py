"""BicubicUNet — SR3/WaveGrad-style video UNet for the x8/x16 tasks.

Counterpart of ``flair_tpu/models/sr3.py`` (reference sr3.py:317-611,
scripts/video_sample.py:73-115). Continuous noise-level conditioning; per
level ResnetBlock → [3-D temporal ResBlock] → [SelfAttention] →
[TemporalAttention] → [BasicVSR++], every temporal module gated by a
TemporalWrapper2. As in the JAX package, SPyNet flows are computed once per
VSR++ resolution (downsized with antialiasing first) and shared by every
VSR++ site there; ``compute_flows`` exposes that step so the pipeline runs
it once per window.

Public layout: x, low_res, rnn_input are (B, T, H, W, 3) and the output is
(B, T, H, W, 3); inside, activations are (B·T, C, H, W) channels_last. The
trunk runs in ``dtype`` (bf16 on the card); norms use float32 statistics,
the noise MLP, SPyNet and the final block stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.embed import sr3_noise_embedding
from ..ops.resize import resize_bilinear_aa
from .blocks import ResBlock, SR3ResnetBlock, SR3SelfAttention
from .common import Conv2d, Dense, GroupNorm32, nchw, nhwc, random_init_, silu
from .registry import register_model
from .spynet import SPyNet
from .temporal import TemporalAttention, TemporalWrapper2
from .vsrpp import BasicVSRPP, compose_second_order_flows, resize_weight_map


class SR3LevelBlock(nn.Module):
    """ResnetBlocWithAttn (sr3.py:229-314): resnet + optional temporal stack."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, norm_groups: int,
                 *, conv_3d: bool, spatial_attn: bool, temporal_attn: bool,
                 vsrpp: bool, num_frames: int, head_dim: int,
                 deform_groups: int = 16, dtype=torch.float32):
        super().__init__()
        c = out_ch
        self.res_block = SR3ResnetBlock(in_ch, c, emb_dim, norm_groups, dtype)
        if conv_3d:
            self.conv_3d = ResBlock(c, c, emb_dim, dims=3,
                                    kernel_size=(3, 1, 1), dtype=dtype)
            self.conv_3d_gate = TemporalWrapper2(c, emb_dim, dtype)
        if spatial_attn:
            self.attn = SR3SelfAttention(c, norm_groups=norm_groups,
                                         dtype=dtype)
        if temporal_attn:
            self.temp_attn = TemporalAttention(
                c, num_frames=num_frames, num_heads=8,
                num_head_channels=head_dim, dtype=dtype)
            self.temp_attn_gate = TemporalWrapper2(c, emb_dim, dtype)
        if vsrpp:
            self.vsrpp = BasicVSRPP(c, max_residue_magnitude=5.0,
                                    deform_groups=deform_groups, dtype=dtype)
            self.vsrpp_gate = TemporalWrapper2(c, emb_dim, dtype)

    def forward(self, x, emb, b: int, flows=None, vsrpp_weights=None,
                enable_cross_frames: bool = True):
        x = self.res_block(x, emb, b)
        if hasattr(self, "conv_3d") and enable_cross_frames:
            x = self.conv_3d_gate(x, self.conv_3d(x, emb, b), emb)
        if hasattr(self, "attn"):
            x = self.attn(x, b)
        if hasattr(self, "temp_attn") and enable_cross_frames:
            x = self.temp_attn_gate(x, self.temp_attn(x, b), emb)
        if hasattr(self, "vsrpp") and enable_cross_frames:
            fwd, bwd = flows[0], flows[1]
            out = self.vsrpp(
                x, b, fwd, bwd, vsrpp_weights,
                flows_forward2=flows[2] if len(flows) > 2 else None,
                flows_backward2=flows[3] if len(flows) > 3 else None)
            x = self.vsrpp_gate(x, out, emb)
        return x


@register_model("bicubic_unet")
class BicubicUNet(nn.Module):
    """SR3-style video UNet (sr3.py:317-525) with the registry defaults of
    the JAX package (inner 64, mults (1, 2, 4, 8, 16), attention at 64/32,
    VSR++ at 512/256, 16 deform groups)."""

    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 64, norm_groups: int = 16,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 16),
                 attn_res: Sequence[int] = (64, 32),
                 vsrpp_res: Sequence[int] = (512, 256),
                 spatial_attn: bool = False, temporal_attn: bool = True,
                 res_blocks: int = 1, image_size: int = 512,
                 cross_frame_module: bool = True, num_frames: int = 7,
                 head_dim: int = 64, deform_groups: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.inner_channel = inner_channel
        self.channel_mults = tuple(channel_mults)
        self.vsrpp_res = tuple(vsrpp_res)
        self.res_blocks = res_blocks
        self.image_size = image_size
        self.cross_frame_module = cross_frame_module
        self.dtype = dtype
        cross = cross_frame_module
        inner = inner_channel

        def flags(res):
            return dict(spatial_attn=(res in attn_res) and spatial_attn,
                        temporal_attn=(res in attn_res) and temporal_attn
                        and cross,
                        vsrpp=(res in vsrpp_res) and cross)

        common = dict(num_frames=num_frames, head_dim=head_dim,
                      deform_groups=deform_groups, dtype=dtype)
        self.mlp_in = Dense(inner, inner * 4)
        self.mlp_out = Dense(inner * 4, inner)
        if cross and len(vsrpp_res) > 0:
            self.spynet = SPyNet()
        self.conv_in = Conv2d(in_channel, inner, 3, dtype=dtype)
        feat_ch = [inner]
        ch = inner
        now_res = image_size
        li = 0
        for ind, mult in enumerate(channel_mults):
            c = inner * mult
            for _ in range(res_blocks):
                setattr(self, f"down_{li}", SR3LevelBlock(
                    ch, c, inner, norm_groups, conv_3d=cross,
                    **flags(now_res), **common))
                ch = c
                feat_ch.append(ch)
                li += 1
            if ind != len(channel_mults) - 1:
                setattr(self, f"downsample_{ind}",
                        Conv2d(c, c, 3, stride=2, padding=1, dtype=dtype))
                feat_ch.append(c)
                now_res //= 2
        for mi in range(2):
            setattr(self, f"mid_{mi}", SR3LevelBlock(
                ch, ch, inner, norm_groups, conv_3d=cross,
                spatial_attn=spatial_attn,
                temporal_attn=temporal_attn and cross, vsrpp=False, **common))
        li = 0
        for ind in reversed(range(len(channel_mults))):
            c = inner * channel_mults[ind]
            for _ in range(res_blocks + 1):
                setattr(self, f"up_{li}", SR3LevelBlock(
                    ch + feat_ch.pop(), c, inner, norm_groups, conv_3d=cross,
                    **flags(now_res), **common))
                ch = c
                li += 1
            if ind >= 1:
                setattr(self, f"upsample_{ind}",
                        Conv2d(ch, ch, 3, dtype=dtype))
                now_res *= 2
        # the final Block stays float32 (not converted by sr3.py:528-541)
        self.final_norm = GroupNorm32(ch, norm_groups)
        self.final_conv = Conv2d(ch, out_channel, 3)

    random_init = random_init_

    def compute_flows(self, rnn_input, enable_cross_frames: bool = True):
        """{res: (fwd, bwd, fwd2, bwd2)} SPyNet flows of a (B, T, H, W, 3)
        [-1, 1] clip, each (B, T-1 | T, 2, res, res) float32 — constant
        across a window's sampler steps."""
        b, t = rnn_input.shape[:2]
        flows = {}
        cross = self.cross_frame_module and enable_cross_frames
        if not (cross and len(self.vsrpp_res) > 0 and t > 1):
            return flows
        lq01 = torch.clamp((rnn_input.float() + 1) / 2, 0, 1)
        for res in self.vsrpp_res:
            lq = (lq01 if lq01.shape[2] == res
                  else resize_bilinear_aa(lq01, (res, res)))
            l1 = nchw(lq[:, :-1].reshape(b * (t - 1), res, res, 3))
            l2 = nchw(lq[:, 1:].reshape(b * (t - 1), res, res, 3))
            fwd = self.spynet(l2, l1).reshape(b, t - 1, 2, res, res)
            bwd = self.spynet(l1, l2).reshape(b, t - 1, 2, res, res)
            flows[res] = (fwd, bwd) + compose_second_order_flows(fwd, bwd)
        return flows

    def forward(self, x, noise_level, low_res=None, rnn_input=None,
                enable_cross_frames: bool = True, vsrpp_weights=None,
                flows: Optional[dict] = None):
        """x, low_res, rnn_input (B, T, H, W, 3); noise_level (B, T).
        ``flows``: precomputed ``compute_flows`` dict (computed here when
        None). Returns eps (B, T, H, W, 3) float32."""
        b, t, hh, ww = x.shape[:4]
        n = b * t
        if rnn_input is None:
            rnn_input = low_res
        if low_res is not None:
            x = torch.cat([low_res, x], dim=-1)
        emb = sr3_noise_embedding(noise_level.reshape(n), self.inner_channel)
        emb = self.mlp_out(silu(self.mlp_in(emb)))         # (N, inner) f32
        if flows is None:
            flows = self.compute_flows(rnn_input, enable_cross_frames)
        wmaps = {}
        if vsrpp_weights is not None and vsrpp_weights.dim() == 5:
            for res in set(self.vsrpp_res):
                wmaps[res] = (vsrpp_weights if vsrpp_weights.shape[2] in (1, res)
                              else resize_weight_map(vsrpp_weights, res, res))

        def level(name, h, res):
            return getattr(self, name)(
                h, emb, b, flows.get(res), wmaps.get(res, vsrpp_weights),
                enable_cross_frames)

        h = nchw(x.reshape(n, hh, ww, x.shape[-1])).to(self.dtype)
        h = self.conv_in(h)
        feats = [h]
        now_res = self.image_size
        li = 0
        nm = len(self.channel_mults)
        for ind in range(nm):
            for _ in range(self.res_blocks):
                h = level(f"down_{li}", h, now_res)
                li += 1
                feats.append(h)
            if ind != nm - 1:
                h = getattr(self, f"downsample_{ind}")(h)
                feats.append(h)
                now_res //= 2
        for mi in range(2):
            h = getattr(self, f"mid_{mi}")(h, emb, b, None, vsrpp_weights,
                                           enable_cross_frames)
        li = 0
        for ind in reversed(range(nm)):
            for _ in range(self.res_blocks + 1):
                h = level(f"up_{li}", torch.cat([h, feats.pop()], dim=1),
                          now_res)
                li += 1
            if ind >= 1:
                # nearest 2× (identical to the reference's repeat) + conv
                h = getattr(self, f"upsample_{ind}")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
                now_res *= 2
        h = silu(self.final_norm(h.float(), b))
        eps = self.final_conv(h)
        return nhwc(eps).reshape(b, t, hh, ww, -1)
