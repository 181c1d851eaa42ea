"""VQFR v2, an alternative face prior (torch.nn, NCHW).

Counterpart of ``flair_tpu/models/vqfr.py`` (reference vqfr.py:11-586): a
VQ-GAN encoder, a codebook read by nearest code or by a predicted index,
a VQ-GAN decoder whose per-level features are the texture, and a parallel
"main" decoder that warps those features onto the degraded input with a
modulated deformable conv at every scale (``TextureWarpingModule``).

The deformable conv is the plain ``ops/deform.modulated_deform_conv2d`` on
every device, as the JAX package calls its plain (XLA) version here: its
offsets come straight from a conv, with no flow anchors and no raw prep,
and Cout = Cin, none of which the DCN kernel (``csrc/dcn_raw.cu``) takes.
The CodeFormer blocks are shared (``models/codeformer.py``). Module names
follow the flax scopes (``utils/convert.from_flax``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform import modulated_deform_conv2d
from ..ops.resize import resize_bilinear
from .codeformer import (CFAttnBlock, CFDownsample, CFResBlock, CFUpsample,
                         GNorm, LayerNorm, VectorQuantizer)
from .common import Conv2d, Dense, nchw, nhwc
from .registry import register_model


class VQFRResBlock(CFResBlock):
    """norm → SiLU → conv, twice, with a 1×1 skip ``residual_func``
    (vqfr.py:107-139)."""

    skip_name = "residual_func"


class L2VectorQuantizer(VectorQuantizer):
    """Nearest code with straight-through (vqfr.py:11-77); returns (z_q,
    loss, indices (B, H·W))."""

    def __init__(self, num_code: int = 1024, code_dim: int = 256):
        super().__init__(num_code, code_dim, beta=0.25)

    def forward(self, z):
        z_q, loss, stats = super().forward(z)
        return z_q, loss, stats["min_encoding_indices"].reshape(z.shape[0], -1)

    def get_feature(self, indices, shape):
        """Indices → codebook rows in ``shape`` (B, H, W, C)."""
        return self.get_codebook_feat(indices, shape)


def _resize(x, out_hw):
    """Half-pixel bilinear resize of (N, C, H, W) (``ops.resize``)."""
    return nchw(resize_bilinear(nhwc(x), out_hw))


def _up2(x):
    """Nearest ×2 (the JAX package's repeat)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class VQGANEncoder(nn.Module):
    """(vqfr.py:190-259)."""

    def __init__(self, base_channels: int, channel_multipliers: Sequence[int],
                 num_blocks: int, use_attention: bool, code_dim: int,
                 dtype=torch.float32):
        super().__init__()
        cm = tuple(channel_multipliers)
        self.plan = []
        ch = base_channels * cm[0]
        self.conv_in = Conv2d(3, ch, 3, dtype=dtype)
        for i in range(len(cm)):
            if i != 0:
                self.add_module(f"down{i}", CFDownsample(ch, dtype))
                self.plan.append(f"down{i}")
            out_ch = base_channels * cm[i]
            for j in range(num_blocks):
                self.add_module(f"block{i}_{j}",
                                VQFRResBlock(ch, out_ch, dtype))
                self.plan.append(f"block{i}_{j}")
                ch = out_ch
                if i == len(cm) - 1 and use_attention:
                    self.add_module(f"attn{i}_{j}", CFAttnBlock(ch, dtype))
                    self.plan.append(f"attn{i}_{j}")
        self.mid1 = VQFRResBlock(ch, ch, dtype)
        self.mid_attn = CFAttnBlock(ch, dtype) if use_attention else None
        self.mid2 = VQFRResBlock(ch, ch, dtype)
        self.norm_out = GNorm(ch)
        self.conv_out = Conv2d(ch, code_dim, 3, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for name in self.plan:
            x = getattr(self, name)(x)
        x = self.mid1(x)
        if self.mid_attn is not None:
            x = self.mid_attn(x)
        x = self.mid2(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class VQGANDecoder(nn.Module):
    """(vqfr.py:262-339). ``forward(x, return_feat)`` returns x, and with
    ``return_feat`` also {"Level_2^i": the features after level i}."""

    def __init__(self, base_channels: int, channel_multipliers: Sequence[int],
                 num_blocks: int, use_attention: bool, code_dim: int,
                 dtype=torch.float32):
        super().__init__()
        cm = tuple(channel_multipliers)
        n = len(cm)
        ch = base_channels * cm[-1]
        self.conv_in = Conv2d(code_dim, ch, 3, dtype=dtype)
        self.mid1 = VQFRResBlock(ch, ch, dtype)
        self.mid_attn = CFAttnBlock(ch, dtype) if use_attention else None
        self.mid2 = VQFRResBlock(ch, ch, dtype)
        self.plan = []      # (module names, the level they end)
        for i in reversed(range(n)):
            names = []
            if i != n - 1:
                self.add_module(f"up{i}", CFUpsample(ch, dtype))
                names.append(f"up{i}")
            out_ch = base_channels * cm[i]
            for j in range(num_blocks):
                self.add_module(f"block{i}_{j}",
                                VQFRResBlock(ch, out_ch, dtype))
                names.append(f"block{i}_{j}")
                ch = out_ch
                if i == n - 1 and use_attention:
                    self.add_module(f"attn{i}_{j}", CFAttnBlock(ch, dtype))
                    names.append(f"attn{i}_{j}")
            self.plan.append((names, f"Level_{2 ** i}"))

    def forward(self, x, return_feat: bool = False):
        x = self.mid1(self.conv_in(x))
        if self.mid_attn is not None:
            x = self.mid_attn(x)
        x = self.mid2(x)
        feats = {}
        for names, level in self.plan:
            for name in names:
                x = getattr(self, name)(x)
            feats[level] = x
        return (x, feats) if return_feat else x


class DecoderOut(nn.Module):
    """The shared norm → SiLU → 3-channel conv head (decoder.conv_out, which
    the main branch reuses, vqfr.py:581-584)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm_out = GNorm(channels)
        self.conv_out = Conv2d(channels, 3, 3, dtype=dtype)

    def forward(self, x):
        return self.conv_out(F.silu(self.norm_out(x)))


class DCNv2Pack(nn.Module):
    """Modulated deformable conv whose offsets and mask a conv predicts
    from ``feat`` (dcn/deform_conv.py DCNv2Pack, used at vqfr.py:341-379):
    27·G channels split in three, the first two concatenated into (G, 9, 2)
    offsets in (dy, dx) order, the sigmoid of the third the mask. The
    offset conv starts at zero, so an untrained pack is a plain conv."""

    def __init__(self, in_ch: int, features: int, cond_ch: int,
                 deformable_groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.groups = deformable_groups
        self.conv_offset = Conv2d(cond_ch, 27 * deformable_groups, 3,
                                  zero_init=True, dtype=dtype)
        self.weight = nn.Parameter(torch.randn(features, in_ch, 3, 3)
                                   / (9 * in_ch) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, feat):
        g = self.groups
        out = nhwc(self.conv_offset(feat))
        b, h, w, _ = out.shape
        o1, o2, mask = torch.chunk(out, 3, dim=-1)
        offset = torch.cat([o1, o2], dim=-1).float().reshape(b, h, w, g, 9, 2)
        mask = torch.sigmoid(mask.float()).reshape(b, h, w, g, 9)
        y = modulated_deform_conv2d(nhwc(x).float(), offset, mask,
                                    self.weight, self.bias, padding=1)
        return nchw(y).to(x.dtype)


class TextureWarpingModule(nn.Module):
    """(vqfr.py:382-426): offsets from the input features (resized to this
    level) and the texture, refined by the previous level's offsets when
    there are any; returns (warped texture, offsets)."""

    def __init__(self, channel: int, inpfeat_dim: int,
                 cond_downscale_rate: int, deformable_groups: int,
                 prev_offset_ch: int = 0, dtype=torch.float32):
        super().__init__()
        c = channel
        self.rate = cond_downscale_rate
        self.off1_0 = Conv2d(inpfeat_dim + c, c, 1, dtype=dtype)
        self.off1_n0 = GNorm(c)
        self.off1_1 = Conv2d(c, c, 7, groups=c, dtype=dtype)
        self.off1_n1 = GNorm(c)
        self.off1_2 = Conv2d(c, c, 1, dtype=dtype)
        self.off2 = Conv2d(c + prev_offset_ch, c, 3, dtype=dtype)
        self.off2_n = GNorm(c)
        self.dcn = DCNv2Pack(c, c, c, deformable_groups, dtype)

    def forward(self, x_main, inpfeat, previous_offset=None):
        h, w = inpfeat.shape[2:]
        cond = _resize(inpfeat, (h // self.rate, w // self.rate))
        o = self.off1_0(torch.cat([cond, x_main], dim=1))
        o = self.off1_1(F.silu(self.off1_n0(o)))
        o = self.off1_2(F.silu(self.off1_n1(o)))
        if previous_offset is not None:
            o = torch.cat([o, previous_offset.to(o.dtype)], dim=1)
        o = F.silu(self.off2_n(self.off2(o)))
        return self.dcn(x_main, o), o


@register_model("vqfr")
class VQFRv2(nn.Module):
    """Full VQFR (vqfr.py:491-586). ``forward(x_lq, fidelity_ratio)`` takes
    (B, 3, S, S) and returns a dict of enc_feat, texture_dec and main_dec
    (B, 3, S, S), and in Predict mode quant_logit (B, (S/2^(n-1))², num_code).
    """

    def __init__(self, base_channels: int = 64,
                 channel_multipliers: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_enc_blocks: int = 2, use_enc_attention: bool = True,
                 num_dec_blocks: int = 2, use_dec_attention: bool = True,
                 code_dim: int = 256, inpfeat_dim: int = 32,
                 code_selection_mode: str = "Predict",
                 deformable_groups: int = 4, num_code: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        if code_selection_mode not in ("Predict", "Nearest"):
            raise ValueError(f"unknown code_selection_mode: "
                             f"{code_selection_mode!r}")
        cm = tuple(channel_multipliers)
        n = len(cm)
        self.n = n
        self.code_dim = code_dim
        self.code_selection_mode = code_selection_mode
        self.inpfeat_extraction = Conv2d(3, inpfeat_dim, 3, dtype=dtype)
        self.encoder = VQGANEncoder(base_channels, cm, num_enc_blocks,
                                    use_enc_attention, code_dim, dtype)
        self.quantizer = L2VectorQuantizer(num_code, code_dim)
        if code_selection_mode == "Predict":
            self.feat2index_norm = LayerNorm(code_dim)
            self.feat2index = Dense(code_dim, num_code, dtype=dtype)
        self.decoder = VQGANDecoder(base_channels, cm, num_dec_blocks,
                                    use_dec_attention, code_dim, dtype)
        self.decoder_out = DecoderOut(base_channels * cm[0], dtype)
        prev = 0
        for i in reversed(range(n)):
            ch = base_channels * cm[i]
            self.add_module(f"align_Level_{2 ** i}", TextureWarpingModule(
                ch, inpfeat_dim, 2 ** i, deformable_groups, prev, dtype))
            if i != n - 1:
                self.add_module(f"pre_up_{2 ** i}",
                                Conv2d(prev, ch, 3, dtype=dtype))
                self.add_module(f"dec_Level_{2 ** i}",
                                VQFRResBlock(2 * ch, ch, dtype))
            prev = ch

    def forward(self, x_lq, fidelity_ratio: float = 1.0):
        res = {}
        inp_feat = self.inpfeat_extraction(x_lq)
        enc_feat = self.encoder(x_lq)
        res["enc_feat"] = enc_feat
        b, _, hq, wq = enc_feat.shape
        if self.code_selection_mode == "Predict":
            tok = self.feat2index_norm(enc_feat.flatten(2).transpose(1, 2))
            logit = self.feat2index(tok)
            res["quant_logit"] = logit
            quant_feat = self.quantizer.get_feature(
                torch.argmax(logit, dim=-1), (b, hq, wq, self.code_dim))
            quant_feat = nchw(quant_feat).to(enc_feat.dtype)
        else:
            quant_feat, _, _ = self.quantizer(enc_feat)
        dec_x, texture = self.decoder(quant_feat.detach(), return_feat=True)
        res["texture_dec"] = self.decoder_out(dec_x)

        # the main branch (vqfr.py:429-488)
        top = 2 ** (self.n - 1)
        x, offset = getattr(self, f"align_Level_{top}")(
            texture[f"Level_{top}"], inp_feat)
        for i in reversed(range(self.n - 1)):
            lv = 2 ** i
            x = getattr(self, f"pre_up_{lv}")(_up2(x))
            up_off = _resize(offset, (offset.shape[2] * 2,
                                      offset.shape[3] * 2)) * 2.0
            warp_feat, offset = getattr(self, f"align_Level_{lv}")(
                texture[f"Level_{lv}"], inp_feat, up_off)
            x = getattr(self, f"dec_Level_{lv}")(
                torch.cat([x, warp_feat.to(x.dtype)], dim=1))
        res["main_dec"] = self.decoder_out(texture["Level_1"]
                                           + fidelity_ratio * x)
        return res
