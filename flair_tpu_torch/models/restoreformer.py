"""RestoreFormer and the plain VQVAEGAN, alternative face priors (torch.nn,
NCHW).

Counterpart of ``flair_tpu/models/restoreformer.py`` (reference
restoreformer.py:7-861): a multi-head VQ-VAE-GAN whose encoder keeps its
per-level features (``hs``) and whose transformer decoder CROSS-attends to
them: queries from the encoder feature under ``norm2``, keys and values
from the decoder stream under ``norm1`` (restoreformer.py:636-672). The
decoder attends at one scale more than the encoder (``ex_multi_scale_num``,
restoreformer.py:807-809).

Attention is the JAX package's plain einsum as ``torch.matmul`` and
softmax (float32 logits scaled by 1/√d, channel = head·d + j), not the
flash kernel. The flax modules read the resolution from their input; a
torch module builds its layers up front, so these take the input size
(``resolution``, the reference config's 512). Module names follow the
flax scopes (``utils/convert.from_flax``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .codeformer import (CFDownsample, CFResBlock, CFUpsample, GNorm,
                         VectorQuantizer)
from .common import Conv2d
from .registry import register_model


class RFResBlock(CFResBlock):
    """norm → swish → conv, twice, with a 1×1 skip ``nin_shortcut``
    (restoreformer.py:158-215)."""

    skip_name = "nin_shortcut"


# pad bottom and right by 1, then a VALID stride-2 conv; nearest ×2, then a
# conv: CodeFormer's blocks (restoreformer.py's Downsample / Upsample)
RFDown = CFDownsample
RFUp = CFUpsample


class MultiHeadAttnBlock(nn.Module):
    """Self attention of ``x``, or with ``cross`` attention whose queries
    come from ``y`` under ``norm2`` and keys / values from ``x`` under
    ``norm1`` (restoreformer.py:218-285); the output adds to ``x``."""

    def __init__(self, channels: int, head_size: int = 1,
                 cross: bool = False, dtype=torch.float32):
        super().__init__()
        self.head_size = head_size
        self.norm1 = GNorm(channels)
        if cross:
            self.norm2 = GNorm(channels)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, Conv2d(channels, channels, 1, dtype=dtype))

    def forward(self, x, y: Optional[torch.Tensor] = None):
        b, c, h, w = x.shape
        hs = self.head_size
        d = c // hs
        hx = self.norm1(x)
        hy = hx if y is None else self.norm2(y)

        def heads(t):       # (B, C, H, W) → (B, heads, H·W, d)
            return t.flatten(2).transpose(1, 2).reshape(b, h * w, hs,
                                                        d).transpose(1, 2)

        q, k, v = heads(self.q(hy)), heads(self.k(hx)), heads(self.v(hx))
        logits = torch.matmul(q, k.transpose(-1, -2)).float()
        probs = torch.softmax(logits / math.sqrt(d), dim=-1)
        out = torch.matmul(probs.to(v.dtype), v)       # (B, heads, HW, d)
        out = out.transpose(1, 2).reshape(b, h * w, c).transpose(1, 2)
        return x + self.proj_out(out.reshape(b, c, h, w))


class MultiHeadEncoder(nn.Module):
    """(restoreformer.py:288-413). ``forward(x)`` returns the ``hs`` dict:
    "in", "block_{i}" before each downsample, "block_{n-1}_atten" and
    "mid_atten" around the middle attention, and "out"."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 z_channels: int = 256, double_z: bool = False,
                 enable_mid: bool = True, head_size: int = 4,
                 resolution: int = 512, dtype=torch.float32):
        super().__init__()
        n = len(ch_mult)
        self.n = n
        self.enable_mid = enable_mid
        self.conv_in = Conv2d(3, ch, 3, dtype=dtype)
        self.plan = []      # (module name, hs key to store after it)
        c, curr = ch, resolution
        for i in range(n):
            out_ch = ch * ch_mult[i]
            for j in range(num_res_blocks):
                self.add_module(f"down{i}_block{j}",
                                RFResBlock(c, out_ch, dtype))
                self.plan.append((f"down{i}_block{j}", None))
                c = out_ch
                if curr in attn_resolutions:
                    self.add_module(f"down{i}_attn{j}",
                                    MultiHeadAttnBlock(c, head_size,
                                                       dtype=dtype))
                    self.plan.append((f"down{i}_attn{j}", None))
            if i != n - 1:
                self.plan[-1] = (self.plan[-1][0], f"block_{i}")
                self.add_module(f"down{i}_ds", RFDown(c, dtype))
                self.plan.append((f"down{i}_ds", None))
                curr //= 2
        if enable_mid:
            self.mid_block1 = RFResBlock(c, c, dtype)
            self.mid_attn = MultiHeadAttnBlock(c, head_size, dtype=dtype)
            self.mid_block2 = RFResBlock(c, c, dtype)
        self.norm_out = GNorm(c)
        self.conv_out = Conv2d(c, 2 * z_channels if double_z else z_channels,
                               3, dtype=dtype)

    def forward(self, x):
        hs = {}
        h = self.conv_in(x)
        hs["in"] = h
        for name, key in self.plan:
            h = getattr(self, name)(h)
            if key is not None:
                hs[key] = h
        if self.enable_mid:
            h = self.mid_block1(h)
            hs[f"block_{self.n - 1}_atten"] = h
            h = self.mid_block2(self.mid_attn(h))
            hs["mid_atten"] = h
        hs["out"] = self.conv_out(F.silu(self.norm_out(h)))
        return hs


class MultiHeadDecoder(nn.Module):
    """The plain decoder (restoreformer.py:415-541); with ``cross``, the
    transformer decoder (restoreformer.py:543-675), whose attention blocks
    cross-attend to the encoder's ``hs``: the middle one to "mid_atten",
    level i's to "block_{i}_atten" where there is one, else "block_{i}"."""

    def __init__(self, ch: int = 64, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 enable_mid: bool = True, head_size: int = 4,
                 z_channels: int = 256, resolution: int = 512,
                 cross: bool = False, dtype=torch.float32):
        super().__init__()
        n = len(ch_mult)
        self.enable_mid = enable_mid
        c = ch * ch_mult[-1]
        curr = resolution // 2 ** (n - 1)
        self.conv_in = Conv2d(z_channels, c, 3, dtype=dtype)
        if enable_mid:
            self.mid_block1 = RFResBlock(c, c, dtype)
            self.mid_attn = MultiHeadAttnBlock(c, head_size, cross, dtype)
            self.mid_block2 = RFResBlock(c, c, dtype)
        self.plan = []      # (module name, level whose hs it attends to)
        for i in reversed(range(n)):
            out_c = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                self.add_module(f"up{i}_block{j}",
                                RFResBlock(c, out_c, dtype))
                self.plan.append((f"up{i}_block{j}", None))
                c = out_c
                if curr in attn_resolutions:
                    self.add_module(f"up{i}_attn{j}", MultiHeadAttnBlock(
                        c, head_size, cross, dtype))
                    self.plan.append((f"up{i}_attn{j}", i if cross else None))
            if i != 0:
                self.add_module(f"up{i}_us", RFUp(c, dtype))
                self.plan.append((f"up{i}_us", None))
                curr *= 2
        self.norm_out = GNorm(c)
        self.conv_out = Conv2d(c, out_ch, 3, dtype=dtype)

    def forward(self, z, hs=None):
        h = self.conv_in(z)
        if self.enable_mid:
            h = self.mid_block1(h)
            h = self.mid_attn(h, None if hs is None else hs["mid_atten"])
            h = self.mid_block2(h)
        for name, level in self.plan:
            if level is None:
                h = getattr(self, name)(h)
            else:
                key = f"block_{level}_atten"
                h = getattr(self, name)(h, hs[key if key in hs
                                              else f"block_{level}"])
        return self.conv_out(F.silu(self.norm_out(h)))


class RFVectorQuantizer(VectorQuantizer):
    """(restoreformer.py:7-119): returns (z_q, loss, (perplexity, indices
    (B·H·W,)))."""

    def __init__(self, n_e: int = 1024, e_dim: int = 256, beta: float = 0.25):
        super().__init__(n_e, e_dim, beta)

    def forward(self, z):
        z_q, loss, stats = super().forward(z)
        return z_q, loss, (stats["perplexity"], stats["min_encoding_indices"])


class _VQVAEBase(nn.Module):
    """Encoder → quant_conv → codebook → post_quant_conv → decoder."""

    def __init__(self, n_embed, embed_dim, ch, ch_mult, num_res_blocks,
                 attn_resolutions, z_channels, head_size, resolution,
                 dec_attn, cross, dtype):
        super().__init__()
        self.encoder = MultiHeadEncoder(
            ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
            attn_resolutions=attn_resolutions, z_channels=z_channels,
            head_size=head_size, resolution=resolution, dtype=dtype)
        self.quant_conv = Conv2d(z_channels, embed_dim, 1, dtype=dtype)
        self.quantize = RFVectorQuantizer(n_embed, embed_dim)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, dtype=dtype)
        self.decoder = MultiHeadDecoder(
            ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
            attn_resolutions=dec_attn, head_size=head_size,
            z_channels=z_channels, resolution=resolution, cross=cross,
            dtype=dtype)

    def encode(self, x):
        hs = self.encoder(x)
        quant, emb_loss, info = self.quantize(self.quant_conv(hs["out"]))
        return self.post_quant_conv(quant), emb_loss, info, hs


@register_model("restoreformer")
class RestoreFormer(_VQVAEBase):
    """VQVAEGANMultiHeadTransformer (restoreformer.py:764-861):
    ``forward(x)`` with x (B, 3, resolution, resolution) returns (dec,
    codebook_loss, (perplexity, indices), hs)."""

    def __init__(self, n_embed: int = 1024, embed_dim: int = 256,
                 ch: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 z_channels: int = 256, head_size: int = 4,
                 ex_multi_scale_num: int = 1, resolution: int = 512,
                 dtype=torch.float32):
        dec_attn = list(attn_resolutions)
        for _ in range(ex_multi_scale_num):
            dec_attn = [dec_attn[0], dec_attn[-1] * 2]
        super().__init__(n_embed, embed_dim, ch, ch_mult, num_res_blocks,
                         attn_resolutions, z_channels, head_size, resolution,
                         tuple(dec_attn), True, dtype)

    def forward(self, x):
        quant, emb_loss, info, hs = self.encode(x)
        return self.decoder(quant, hs), emb_loss, info, hs


@register_model("vqvaegan")
class VQVAEGAN(_VQVAEBase):
    """The base VQ-VAE-GAN, with no cross attention (restoreformer.py:
    678-762): ``forward(x)`` returns (dec, codebook_loss, (perplexity,
    indices))."""

    def __init__(self, n_embed: int = 1024, embed_dim: int = 256,
                 ch: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 z_channels: int = 256, head_size: int = 1,
                 resolution: int = 512, dtype=torch.float32):
        super().__init__(n_embed, embed_dim, ch, ch_mult, num_res_blocks,
                         attn_resolutions, z_channels, head_size, resolution,
                         tuple(attn_resolutions), False, dtype)

    def forward(self, x):
        quant, emb_loss, info, _ = self.encode(x)
        return self.decoder(quant), emb_loss, info
