"""UNet building blocks: ADM-style ResBlock and attention, SR3-style blocks.

Counterpart of ``flair_tpu/models/blocks.py`` (reference unet_new.py:233-429
and sr3.py:63-200). Activations are (B·T, C, H, W) channels_last; ``b`` is
the clip count B; ``emb`` is the folded (B·T, E) embedding.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention, flash_attention
from .common import Conv2d, Conv3d, Dense, GroupNorm32, nchw, nhwc, silu


class ResBlock(nn.Module):
    """ADM residual block (unet_new.py:233-330); ``dims=3`` applies its
    convs over (T, H, W) with ``kernel_size`` (3 → 3×3×3; the SR3 trunk's
    temporal block passes (3, 1, 1)). ``up`` / ``down`` resample both the
    normed activation and the skip input before ``in_conv``: nearest 2×
    (``Upsample2x(use_conv=False)``) or a 2×2 average pool."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, *,
                 use_scale_shift_norm: bool = False, dims: int = 2,
                 kernel_size=3, up: bool = False, down: bool = False,
                 use_conv_skip: bool = False, dtype=torch.float32):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down

        def conv(zero=False):
            if dims == 3:
                ks = ((kernel_size,) * 3 if isinstance(kernel_size, int)
                      else tuple(kernel_size))
                return Conv3d(in_ch if not zero else out_ch, out_ch, ks,
                              zero_init=zero, dtype=dtype)
            return Conv2d(in_ch if not zero else out_ch, out_ch, 3,
                          zero_init=zero, dtype=dtype)

        self.dims = dims
        self.in_norm = GroupNorm32(in_ch, 32)
        self.in_conv = conv()
        self.emb_proj = Dense(emb_dim,
                              2 * out_ch if use_scale_shift_norm else out_ch,
                              dtype=dtype)
        self.out_norm = GroupNorm32(out_ch, 32)
        self.out_conv = conv(zero=True)
        self.skip = None
        if in_ch != out_ch:
            self.skip = Conv2d(in_ch, out_ch, 3 if use_conv_skip else 1,
                               dtype=dtype)

    def _conv(self, conv, x, b):
        return conv(x, b) if self.dims == 3 else conv(x)

    def forward(self, x, emb, b: int):
        h = silu(self.in_norm(x, b))
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self._conv(self.in_conv, h, b)
        emb_out = self.emb_proj(silu(emb))[:, :, None, None]  # (N, C', 1, 1)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_norm(h, b) * (1 + scale) + shift
        else:
            h = self.out_norm(h + emb_out.to(h.dtype), b)
        h = self._conv(self.out_conv, silu(h), b)
        skip = x if self.skip is None else self.skip(x)
        return skip + h


def _split_heads(qkv, heads: int):
    """q, k, v as strided views of the packed (N, S, 3C) Dense output. The
    reference interleaves them PER HEAD (``qkv.reshape(N, S, heads, 3, Dh)``,
    QKVAttentionLegacy), which the flax → torch map keeps; each view is
    (N, S, heads, Dh) with strides (S·3C, 3C, 3·Dh, 1), which the flash
    kernel reads in place."""
    n, s, c3 = qkv.shape
    return qkv.reshape(n, s, heads, 3, c3 // (3 * heads)).unbind(dim=3)


class AttentionBlock(nn.Module):
    """Spatial self-attention with pre-norm and a zero-init projection
    (unet_new.py:332-378), through ``flash_attention``; the softmax scale
    is 1/√Dh (legacy head split)."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1, dtype=torch.float32):
        super().__init__()
        c = channels
        self.heads = (num_heads if num_head_channels == -1
                      else c // num_head_channels)
        self.norm = GroupNorm32(c, 32)
        self.qkv = Dense(c, 3 * c, dtype=dtype)
        self.proj = Dense(c, c, zero_init=True, dtype=dtype)

    def attend(self, x, b: int):
        """(N, C, H, W) → the attention output (N, H·W, C), before proj."""
        n, c, h, w = x.shape
        t = nhwc(self.norm(x, b)).reshape(n, h * w, c)
        q, k, v = _split_heads(self.qkv(t), self.heads)
        return flash_attention(q, k, v).reshape(n, h * w, c)

    def forward(self, x, b: int):
        n, c, h, w = x.shape
        out = self.proj(self.attend(x, b))
        return x + nchw(out.reshape(n, h, w, c))


class AttentionBottleBlock(AttentionBlock):
    """Bottleneck attention (unet_new.py:381-429): ``emb_proj(silu(emb))``,
    cast to the trunk dtype, is added to the attention output BEFORE the
    zero-init projection."""

    def __init__(self, channels: int, emb_dim: int, num_heads: int = 1,
                 num_head_channels: int = -1, dtype=torch.float32):
        super().__init__(channels, num_heads, num_head_channels, dtype)
        self.emb_proj = Dense(emb_dim, channels, dtype=dtype)

    def forward(self, x, emb, b: int):
        n, c, h, w = x.shape
        out = self.attend(x, b)
        out = out + self.emb_proj(silu(emb))[:, None, :].to(out.dtype)
        out = self.proj(out)
        return x + nchw(out.reshape(n, h, w, c))


class SR3Block(nn.Module):
    """GroupNorm → Swish → 3×3 conv (sr3.py:112-124)."""

    def __init__(self, in_ch: int, out_ch: int, norm_groups: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm32(in_ch, norm_groups)
        self.conv = Conv2d(in_ch, out_ch, 3, dtype=dtype)

    def forward(self, x, b: int):
        return self.conv(silu(self.norm(x, b)))


class SR3ResnetBlock(nn.Module):
    """SR3 residual block with additive noise conditioning
    (sr3.py:64-82, 126-160)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 norm_groups: int = 32, dtype=torch.float32):
        super().__init__()
        self.block1 = SR3Block(in_ch, out_ch, norm_groups, dtype)
        self.noise_proj = Dense(emb_dim, out_ch, dtype=dtype)
        self.block2 = SR3Block(out_ch, out_ch, norm_groups, dtype)
        self.res_conv = (Conv2d(in_ch, out_ch, 1, dtype=dtype)
                         if in_ch != out_ch else None)

    def forward(self, x, emb, b: int):
        h = self.block1(x, b)
        h = h + self.noise_proj(emb)[:, :, None, None].to(h.dtype)
        h = self.block2(h, b)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class SR3SelfAttention(nn.Module):
    """Full spatial self-attention scaled by 1/√C over the WHOLE channel dim
    — the reference's scale (sr3.py:185), kept on purpose."""

    def __init__(self, channels: int, n_head: int = 1, norm_groups: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.n_head = n_head
        self.norm = GroupNorm32(channels, norm_groups)
        self.qkv = Dense(channels, 3 * channels, use_bias=False, dtype=dtype)
        self.out = Dense(channels, channels, dtype=dtype)

    def forward(self, x, b: int):
        n, c, h, w = x.shape
        nh = self.n_head
        t = nhwc(self.norm(x, b)).reshape(n, h * w, c)
        qkv = self.qkv(t).reshape(n, h * w, nh, 3, c // nh)
        q, k, v = qkv.unbind(dim=3)
        out = dot_product_attention(q, k, v, scale=1.0 / math.sqrt(c))
        out = self.out(out.reshape(n, h * w, c))
        return x + nchw(out.reshape(n, h, w, c))
