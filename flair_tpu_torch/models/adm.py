"""BlurUNet — ADM / guided-diffusion video UNet for the gaussian and jpeg tasks.

Counterpart of ``flair_tpu/models/adm.py::BlurUNet`` (reference
unet_new.py:901-1362, scripts/video_sample.py:118-156): channel_mult
(0.5, 1, 1, 2, 2, 4, 4) × 128, learned-range variance (6 output channels),
scale-shift norm, ResBlock up/down, spatial attention at ds {16, 32, 64} and
in the bottleneck (``flash_attention``, kernel K2 on the card), 5-frame
temporal attention and 3×3×3 temporal ResBlocks, BasicVSR++ at ds {1, 2}
with M = 10 and 16 deform groups (kernel K1 on the card).

The flows differ from the BicubicUNet's: ``rnn_input`` is resized to each
VSR++ resolution with PLAIN bicubic (no antialias), then mapped to [0, 1]
and clipped (adm.py:104-116). ``compute_flows`` exposes that step, so the
pipeline runs it once per window. Module names follow the flax scopes
(``in_4_0_attn``, ``mid_attn``, ``in_0_0_res3d``, ``in_0_0_vsrpp``, …).

Public layout: x, low_res, rnn_input (B, T, H, W, 3), timesteps (B, T)
original-schedule indices; output (B, T, H, W, out_channels) float32 (ε and
the variance fractions). The trunk runs in ``dtype``; norms use float32
statistics; the time MLP, SPyNet and the final norm + conv stay float32.
Only the ``resblock_updown=True``, ``temporal_block=True`` form is ported
(every reference config uses it; ``enable_cross_frames=False`` skips the
temporal modules at call time).

``use_checkpoint`` recomputes the activations of every ResBlock (2-D and
3-D), AttentionBlock, AttentionBottleBlock, TemporalAttention and
BasicVSRPP in the backward, the set the JAX package wraps in ``nn.remat``
(adm.py:133-143); parameter names do not change.

Also ``SuperResModel`` (a BlurUNet on the bilinear upsample of ``low_res``,
its parameters under ``unet.``) and ``EncoderUNetModel`` (the down trunk,
middle block and the ``adaptive`` pooled head), unet_new.py:1365-1593.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.embed import timestep_embedding
from ..ops.resize import resize_bicubic, resize_bilinear
from .blocks import AttentionBlock, AttentionBottleBlock, ResBlock
from .common import (Conv2d, Dense, GroupNorm32, checkpointed, nchw, nhwc,
                     random_init_, silu)
from .registry import register_model
from .spynet import SPyNet
from .temporal import TemporalAttention
from .vsrpp import BasicVSRPP, compose_second_order_flows


@register_model("blur_unet")
class BlurUNet(nn.Module):
    """ADM video UNet with the JAX package's defaults (adm.py:38-60)."""

    def __init__(self, image_size: int = 512, in_channels: int = 6,
                 model_channels: int = 128, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (16, 32, 64),
                 rnn_resolutions: Sequence[int] = (1, 2),
                 channel_mult: Sequence[float] = (0.5, 1, 1, 2, 2, 4, 4),
                 num_heads: int = 1, num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True, temporal_frames: int = 5,
                 deform_groups: int = 16, use_checkpoint: bool = False,
                 dtype=torch.float32):
        super().__init__()
        mc = model_channels
        self.image_size = image_size
        self.use_checkpoint = use_checkpoint
        self.model_channels = mc
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.rnn_resolutions = tuple(int(s) for s in rnn_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.dtype = dtype
        emb_dim = 4 * mc
        ss = dict(use_scale_shift_norm=use_scale_shift_norm, dtype=dtype)
        heads = dict(num_heads=num_heads, num_head_channels=num_head_channels)

        def stack(base, c, ds):
            """The modules after the ResBlock ``<base>_res``."""
            setattr(self, base + "_res3d", ResBlock(c, c, emb_dim, dims=3, **ss))
            if ds in self.attention_resolutions:
                setattr(self, base + "_attn",
                        AttentionBlock(c, **heads, dtype=dtype))
                setattr(self, base + "_attn_temporal", TemporalAttention(
                    c, num_frames=temporal_frames, **heads, dtype=dtype))
            if ds in self.rnn_resolutions:
                setattr(self, base + "_vsrpp", BasicVSRPP(
                    c, deform_groups=deform_groups, dtype=dtype))

        self.time_embed_0 = Dense(mc, emb_dim)
        self.time_embed_1 = Dense(emb_dim, emb_dim)
        if self.rnn_resolutions:
            self.spynet = SPyNet()
        ch = int(self.channel_mult[0] * mc)
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype)
        hs_ch = [ch]
        ds = 1
        last = len(self.channel_mult) - 1
        for level, mult in enumerate(self.channel_mult):
            c = int(mult * mc)
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res",
                        ResBlock(ch, c, emb_dim, **ss))
                ch = c
                stack(f"in_{level}_{i}", c, ds)
                hs_ch.append(ch)
            if level != last:
                setattr(self, f"in_{level}_down",
                        ResBlock(c, c, emb_dim, down=True, **ss))
                hs_ch.append(c)
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, emb_dim, **ss)
        self.mid_res3d_1 = ResBlock(ch, ch, emb_dim, dims=3, **ss)
        self.mid_attn_temporal = TemporalAttention(
            ch, num_frames=temporal_frames, **heads, dtype=dtype)
        self.mid_res3d_2 = ResBlock(ch, ch, emb_dim, dims=3, **ss)
        self.mid_attn = AttentionBottleBlock(ch, emb_dim, **heads, dtype=dtype)
        self.mid_res2 = ResBlock(ch, ch, emb_dim, **ss)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            c = int(mult * mc)
            for i in range(num_res_blocks + 1):
                setattr(self, f"out_{level}_{i}_res",
                        ResBlock(ch + hs_ch.pop(), c, emb_dim, **ss))
                ch = c
                stack(f"out_{level}_{i}", c, ds)
                if level and i == num_res_blocks:
                    setattr(self, f"out_{level}_up",
                            ResBlock(c, c, emb_dim, up=True, **ss))
                    ds //= 2
        # the final norm + conv stay float32 (adm.py:283-288)
        self.out_norm = GroupNorm32(ch, 32)
        self.out_conv = Conv2d(ch, out_channels, 3, zero_init=True)

    random_init = random_init_

    def compute_flows(self, rnn_input, enable_cross_frames: bool = True):
        """{res: (fwd, bwd, fwd2, bwd2)} SPyNet flows of a (B, T, H, W, 3)
        [-1, 1] clip at every VSR++ resolution, each (B, T-1 | T, 2, res,
        res) float32 — constant across a window's sampler steps."""
        b, t = rnn_input.shape[:2]
        flows = {}
        if not (enable_cross_frames and self.rnn_resolutions and t > 1):
            return flows
        for res in (self.image_size // s for s in self.rnn_resolutions):
            fi = rnn_input.float()
            if fi.shape[2] != res:
                fi = resize_bicubic(fi, (res, res))
            lq01 = torch.clamp((fi + 1) / 2, 0, 1)
            l1 = nchw(lq01[:, :-1].reshape(b * (t - 1), res, res, 3))
            l2 = nchw(lq01[:, 1:].reshape(b * (t - 1), res, res, 3))
            fwd = self.spynet(l2, l1).reshape(b, t - 1, 2, res, res)
            bwd = self.spynet(l1, l2).reshape(b, t - 1, 2, res, res)
            flows[res] = (fwd, bwd) + compose_second_order_flows(fwd, bwd)
        return flows

    def forward(self, x, timesteps, low_res=None, rnn_input=None,
                enable_cross_frames: bool = True, vsrpp_weights=None,
                flows: Optional[dict] = None):
        """x, low_res, rnn_input (B, T, H, W, 3); timesteps (B, T) integer
        original-schedule indices. ``flows``: a precomputed
        ``compute_flows`` dict (computed here when None). Returns
        (B, T, H, W, out_channels) float32."""
        b, t, hh, ww = x.shape[:4]
        n = b * t
        cross = enable_cross_frames
        if low_res is not None:
            x = torch.cat([x, low_res], dim=-1)
        if rnn_input is None:
            rnn_input = low_res
        emb = timestep_embedding(timesteps.reshape(n), self.model_channels)
        emb = self.time_embed_1(silu(self.time_embed_0(emb)))   # (N, 4mc) f32
        if flows is None:
            flows = self.compute_flows(rnn_input, enable_cross_frames)

        def block(name, *args, **kw):
            module = getattr(self, name)
            if self.use_checkpoint:
                return checkpointed(module, *args, **kw)
            return module(*args, **kw)

        def after_res(h, name, ds):
            """[3-D ResBlock] → [attention → temporal attention] →
            [BasicVSR++] after the ResBlock ``<name>_res`` (the JAX
            package's maybe_temporal_res / maybe_attn / maybe_vsrpp)."""
            if cross:
                h = block(name + "_res3d", h, emb, b)
            if ds in self.attention_resolutions:
                h = block(name + "_attn", h, b)
                if cross:
                    h = block(name + "_attn_temporal", h, b)
            if cross and ds in self.rnn_resolutions:
                fl = flows[h.shape[2]]
                h = block(name + "_vsrpp", h, b, fl[0], fl[1], vsrpp_weights,
                          flows_forward2=fl[2], flows_backward2=fl[3])
            return h

        h = nchw(x.reshape(n, hh, ww, x.shape[-1])).to(self.dtype)
        h = self.conv_in(h)
        hs = [h]
        ds = 1
        last = len(self.channel_mult) - 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = block(f"in_{level}_{i}_res", h, emb, b)
                h = after_res(h, f"in_{level}_{i}", ds)
                hs.append(h)
            if level != last:
                h = block(f"in_{level}_down", h, emb, b)
                hs.append(h)
                ds *= 2
        h = block("mid_res1", h, emb, b)
        if cross:
            h = block("mid_res3d_1", h, emb, b)
        h = block("mid_attn", h, emb, b)
        if cross:
            h = block("mid_attn_temporal", h, b)
        h = block("mid_res2", h, emb, b)
        if cross:
            h = block("mid_res3d_2", h, emb, b)
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = block(f"out_{level}_{i}_res", h, emb, b)
                h = after_res(h, f"out_{level}_{i}", ds)
                if level and i == self.num_res_blocks:
                    h = block(f"out_{level}_up", h, emb, b)
                    ds //= 2
        h = self.out_norm(h, b, act="silu", out_dtype=torch.float32)
        out = self.out_conv(h)
        return nhwc(out).reshape(b, t, hh, ww, -1)


@register_model("superres_unet")
class SuperResModel(nn.Module):
    """A BlurUNet conditioned on ``low_res`` bilinearly upsampled to x's
    size (adm.py:291-306, unet_new.py:1365-1390). The keywords build the
    inner BlurUNet, registered as ``unet`` as the flax scope is."""

    def __init__(self, **unet_kwargs):
        super().__init__()
        self.unet = BlurUNet(**unet_kwargs)

    random_init = random_init_

    def forward(self, x, timesteps, low_res=None, **kwargs):
        """x (B, T, H, W, 3); low_res (B, T, h, w, 3) or None; the rest as
        ``BlurUNet.forward`` takes it (``rnn_input`` defaults to the
        upsample)."""
        up = (None if low_res is None
              else resize_bilinear(low_res, (x.shape[2], x.shape[3])))
        return self.unet(x, timesteps, up, **kwargs)


@register_model("encoder_unet")
class EncoderUNetModel(nn.Module):
    """Half-UNet encoder / classifier (adm.py:309-378, unet_new.py:
    1393-1593): the ADM down trunk (ResBlocks with scale-shift norm,
    attention at ``attention_resolutions`` through ``flash_attention``,
    ResBlock down-sampling), middle ResBlock / attention / ResBlock, then
    the ``adaptive`` head: norm, SiLU, spatial mean and a zero-init Dense.
    x (B, T, H, W, in_channels), timesteps (B, T) → (B, T, out_channels)
    float32. Only ``pool="adaptive"`` is ported, as in the JAX package."""

    def __init__(self, image_size: int = 64, in_channels: int = 3,
                 model_channels: int = 128, out_channels: int = 1000,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (16, 32),
                 channel_mult: Sequence[float] = (1, 2, 4, 8),
                 num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True, pool: str = "adaptive",
                 dtype=torch.float32):
        super().__init__()
        if pool != "adaptive":
            raise NotImplementedError(pool)
        mc = model_channels
        self.model_channels = mc
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.dtype = dtype
        emb_dim = 4 * mc
        ss = dict(use_scale_shift_norm=use_scale_shift_norm, dtype=dtype)
        heads = dict(num_head_channels=num_head_channels, dtype=dtype)
        self.time_embed_0 = Dense(mc, emb_dim)
        self.time_embed_1 = Dense(emb_dim, emb_dim)
        ch = int(self.channel_mult[0] * mc)
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype)
        ds = 1
        last = len(self.channel_mult) - 1
        for level, mult in enumerate(self.channel_mult):
            c = int(mult * mc)
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res",
                        ResBlock(ch, c, emb_dim, **ss))
                ch = c
                if ds in self.attention_resolutions:
                    setattr(self, f"in_{level}_{i}_attn",
                            AttentionBlock(c, **heads))
            if level != last:
                setattr(self, f"in_{level}_down",
                        ResBlock(c, c, emb_dim, down=True, **ss))
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, emb_dim, **ss)
        self.mid_attn = AttentionBlock(ch, **heads)
        self.mid_res2 = ResBlock(ch, ch, emb_dim, **ss)
        self.out_norm = GroupNorm32(ch, 32)
        self.out_proj = Dense(ch, out_channels, zero_init=True)

    random_init = random_init_

    def forward(self, x, timesteps):
        b, t, hh, ww = x.shape[:4]
        n = b * t
        emb = timestep_embedding(timesteps.reshape(n), self.model_channels)
        emb = self.time_embed_1(silu(self.time_embed_0(emb)))   # (N, 4mc) f32
        h = nchw(x.reshape(n, hh, ww, x.shape[-1])).to(self.dtype)
        h = self.conv_in(h)
        ds = 1
        last = len(self.channel_mult) - 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"in_{level}_{i}_res")(h, emb, b)
                if ds in self.attention_resolutions:
                    h = getattr(self, f"in_{level}_{i}_attn")(h, b)
            if level != last:
                h = getattr(self, f"in_{level}_down")(h, emb, b)
                ds *= 2
        h = self.mid_res1(h, emb, b)
        h = self.mid_attn(h, b)
        h = self.mid_res2(h, emb, b)
        h = self.out_norm(h, b, act="silu").float().mean(dim=(2, 3))  # (N, C)
        return self.out_proj(h).reshape(b, t, -1)
