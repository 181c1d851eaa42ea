"""CodeFormer face prior (torch.nn, NCHW).

Counterpart of ``flair_tpu/models/codeformer.py`` (reference
codeformer.py:9-753): a VQ-GAN autoencoder (encoder → codebook →
generator), a 9-layer pre-LN transformer that predicts codebook indices
from the degraded face's latent, AdaIN of the looked-up codes to the
latent's statistics, and SFT fusion of encoder features into the
generator at the ``connect_list`` resolutions.

The flax modules read the resolution from their input; a torch module
builds its layers up front, so the encoder and generator take the image
size (CodeFormer derives it from ``latent_size``). Convs and dense layers
run in ``dtype``; GroupNorm and LayerNorm statistics and outputs are
float32, as flax's float32 parameters promote them. Attention is plain
matmul + softmax (the JAX package's einsum), not the flash kernel.
Module names follow the flax scopes (``utils/convert.from_flax_codeformer``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .common import Conv2d, Dense, random_init_
from .registry import register_model


class GNorm(nn.Module):
    """GroupNorm(32, eps=1e-6, affine), float32 (codeformer.py:9-13)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.weight, self.bias, 1e-6)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6 (torch's default is 1e-5), float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-6)


class CFResBlock(nn.Module):
    """norm → swish → conv, twice, with a 1×1 skip on a channel change
    (codeformer.py:166-195)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GNorm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, dtype=dtype)
        self.norm2 = GNorm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, dtype=dtype)
        if in_ch != out_ch:
            self.conv_out = Conv2d(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_out"):
            x = self.conv_out(x)
        return x + h


class CFAttnBlock(nn.Module):
    """Single-head spatial attention, scale 1/√C (codeformer.py:198-241)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = GNorm(channels)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, Conv2d(channels, channels, 1, dtype=dtype))

    def forward(self, x):
        b, c, h, w = x.shape
        n = self.norm(x)

        def tokens(conv):  # (B, HW, 1, C)
            return conv(n).flatten(2).transpose(1, 2)[:, :, None]

        out = dot_product_attention(tokens(self.q), tokens(self.k),
                                    tokens(self.v))
        out = out[:, :, 0].transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class CFDownsample(nn.Module):
    """Pad (0, 1, 0, 1), then a VALID stride-2 conv (codeformer.py:138-149)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class CFUpsample(nn.Module):
    """Nearest ×2, then a conv (codeformer.py:152-163)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook (codeformer.py:21-94)."""

    def __init__(self, codebook_size: int = 1024, emb_dim: int = 256,
                 beta: float = 0.25):
        super().__init__()
        self.emb_dim = emb_dim
        self.beta = beta
        self.embedding = nn.Parameter(
            (torch.rand(codebook_size, emb_dim) * 2 - 1) / codebook_size)

    def forward(self, z):
        """z (B, C, H, W) → (z_q, loss, stats); indices in (B, H, W) order."""
        zl = z.permute(0, 2, 3, 1)
        flat = zl.reshape(-1, self.emb_dim).float()
        e = self.embedding
        d = ((flat ** 2).sum(-1, keepdim=True) + (e ** 2).sum(-1)
             - 2.0 * flat @ e.T)
        idx = torch.argmin(d, dim=-1)
        z_q = e[idx].reshape(zl.shape).to(z.dtype).permute(0, 3, 1, 2)
        loss = (torch.mean((z_q.detach() - z) ** 2)
                + self.beta * torch.mean((z_q - z.detach()) ** 2))
        z_q = z + (z_q - z).detach()
        e_mean = F.one_hot(idx, e.shape[0]).float().mean(0)
        perplexity = torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))
        stats = {"perplexity": perplexity, "min_encoding_indices": idx,
                 "mean_distance": d.mean()}
        return z_q, loss, stats

    def get_codebook_feat(self, indices, shape):
        """(B·N,) indices → (B, H, W, C) features (codeformer.py:82-94)."""
        return self.embedding[indices.reshape(-1)].reshape(shape)


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax codebook (codeformer.py:97-135): VQAutoEncoder's
    alternative quantiser. ``generator`` draws the Gumbel noise; without
    one the softmax is taken of the plain logits."""

    def __init__(self, codebook_size: int = 1024, emb_dim: int = 256,
                 kl_weight: float = 1e-8, temp: float = 1.0):
        super().__init__()
        self.codebook_size = codebook_size
        self.kl_weight = kl_weight
        self.temp = temp
        self.proj = Conv2d(emb_dim, codebook_size, 1)
        self.embedding = nn.Parameter(torch.randn(codebook_size, emb_dim))

    def forward(self, z, generator: Optional[torch.Generator] = None):
        logits = self.proj(z).permute(0, 2, 3, 1)       # (B, H, W, N)
        if generator is None:
            soft = torch.softmax(logits / self.temp, dim=-1)
        else:
            u = torch.rand(logits.shape, generator=generator,
                           dtype=logits.dtype, device=logits.device)
            g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
            soft = torch.softmax((logits + g) / self.temp, dim=-1)
        z_q = torch.einsum("bhwn,nc->bchw", soft, self.embedding)
        qy = torch.softmax(logits, dim=-1)
        kl = self.kl_weight * torch.mean(
            torch.sum(qy * torch.log(qy * self.codebook_size + 1e-10), dim=-1))
        return z_q, kl, {"min_encoding_indices": torch.argmax(soft, dim=-1)}


class CFEncoder(nn.Module):
    """VQ-GAN encoder (codeformer.py:244-299). ``forward(x)`` returns
    (latent, captures): captures maps a resolution string to the feature
    after the last res block of that level, before its attention."""

    def __init__(self, nf: int = 64, emb_dim: int = 256,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_res_blocks: int = 2, resolution: int = 512,
                 attn_resolutions: Sequence[int] = (16,), dtype=torch.float32):
        super().__init__()
        self.conv_in = Conv2d(3, nf, 3, dtype=dtype)
        self.plan = []      # (module name, capture resolution or None)
        ch, curr, li = nf, resolution, 0
        for i, mult in enumerate(ch_mult):
            out_ch = nf * mult
            for j in range(num_res_blocks):
                self.add_module(f"block{li}", CFResBlock(ch, out_ch, dtype))
                self.plan.append((f"block{li}", str(curr)
                                  if j == num_res_blocks - 1 else None))
                ch, li = out_ch, li + 1
                if curr in attn_resolutions:
                    self.add_module(f"attn{li}", CFAttnBlock(ch, dtype))
                    self.plan.append((f"attn{li}", None))
                    li += 1
            if i != len(ch_mult) - 1:
                self.add_module(f"down{i}", CFDownsample(ch, dtype))
                self.plan.append((f"down{i}", None))
                curr //= 2
        self.mid_block1 = CFResBlock(ch, ch, dtype)
        self.mid_attn = CFAttnBlock(ch, dtype)
        self.mid_block2 = CFResBlock(ch, ch, dtype)
        self.norm_out = GNorm(ch)
        self.conv_out = Conv2d(ch, emb_dim, 3, dtype=dtype)

    def forward(self, x):
        captures = {}
        x = self.conv_in(x)
        for name, capture in self.plan:
            x = getattr(self, name)(x)
            if capture is not None:
                captures[capture] = x
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        return self.conv_out(self.norm_out(x)), captures


class CFGenerator(nn.Module):
    """VQ-GAN generator (codeformer.py:302-354). ``fuse_fn(res, x)`` is
    called after the LAST res block of the deepest level and after the
    FIRST res block of every other level (codeformer.py:668-676)."""

    def __init__(self, nf: int = 64, emb_dim: int = 256,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 num_res_blocks: int = 2, resolution: int = 512,
                 attn_resolutions: Sequence[int] = (16,), dtype=torch.float32):
        super().__init__()
        ch = nf * ch_mult[-1]
        curr = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = Conv2d(emb_dim, ch, 3, dtype=dtype)
        self.mid_block1 = CFResBlock(ch, ch, dtype)
        self.mid_attn = CFAttnBlock(ch, dtype)
        self.mid_block2 = CFResBlock(ch, ch, dtype)
        self.plan = []      # (module name, fuse resolution or None)
        li, deepest = 0, len(ch_mult) - 1
        for i in reversed(range(len(ch_mult))):
            out_ch = nf * ch_mult[i]
            for j in range(num_res_blocks):
                self.add_module(f"block{li}", CFResBlock(ch, out_ch, dtype))
                fuse = (j == num_res_blocks - 1 if i == deepest else j == 0)
                self.plan.append((f"block{li}", str(curr) if fuse else None))
                ch, li = out_ch, li + 1
                if curr in attn_resolutions:
                    self.add_module(f"attn{li}", CFAttnBlock(ch, dtype))
                    self.plan.append((f"attn{li}", None))
                    li += 1
            if i != 0:
                self.add_module(f"up{i}", CFUpsample(ch, dtype))
                self.plan.append((f"up{i}", None))
                curr *= 2
        self.norm_out = GNorm(ch)
        self.conv_out = Conv2d(ch, 3, 3, dtype=dtype)

    def forward(self, x, fuse_fn=None):
        x = self.conv_in(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        for name, fuse in self.plan:
            x = getattr(self, name)(x)
            if fuse is not None and fuse_fn is not None:
                x = fuse_fn(fuse, x)
        return self.conv_out(self.norm_out(x))


def calc_mean_std(feat, eps: float = 1e-5):
    """Per-channel spatial mean and std of (B, C, H, W), with the
    POPULATION variance as ``jnp.var`` (codeformer.py:437-452)."""
    var, mean = torch.var_mean(feat, dim=(2, 3), keepdim=True, correction=0)
    return mean, torch.sqrt(var + eps)


def adaptive_instance_normalization(content, style):
    """AdaIN: give ``content`` the channel statistics of ``style``
    (codeformer.py:454-470)."""
    s_mean, s_std = calc_mean_std(style)
    c_mean, c_std = calc_mean_std(content)
    return (content - c_mean) / c_std * s_std + s_mean


class MultiHeadSelfAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` without a mask: q / k / v
    projections, softmax(q·kᵀ/√Dh)·v per head, output projection. The
    DenseGeneral kernels map to (H·Dh, E) and (E, H·Dh) weights."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(dim, dim, dtype=dtype))

    def forward(self, qk, v):
        b, n, e = qk.shape

        def heads(t):
            return t.reshape(b, n, self.num_heads, e // self.num_heads)

        out = dot_product_attention(heads(self.query(qk)), heads(self.key(qk)),
                                    heads(self.value(v)))
        return self.out(out.reshape(b, n, e))


class TransformerSALayer(nn.Module):
    """Pre-LN self-attention + GELU MLP; ``query_pos`` is added to q and k
    (codeformer.py:531-571)."""

    def __init__(self, embed_dim: int = 512, nhead: int = 8,
                 dim_mlp: int = 1024, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(embed_dim)
        self.self_attn = MultiHeadSelfAttention(embed_dim, nhead, dtype)
        self.norm2 = LayerNorm(embed_dim)
        self.linear1 = Dense(embed_dim, dim_mlp, dtype=dtype)
        self.linear2 = Dense(dim_mlp, embed_dim, dtype=dtype)

    def forward(self, x, query_pos=None):
        h = self.norm1(x)
        qk = h if query_pos is None else h + query_pos
        x = x + self.self_attn(qk, h)
        h = F.gelu(self.linear1(self.norm2(x)), approximate="none")
        return x + self.linear2(h)


class FuseSFTBlock(nn.Module):
    """SFT skip fusion (codeformer.py:574-597)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.encode_enc = CFResBlock(2 * channels, channels, dtype)
        for name in ("scale", "shift"):
            setattr(self, f"{name}_conv1", Conv2d(channels, channels, 3,
                                                  dtype=dtype))
            setattr(self, f"{name}_conv2", Conv2d(channels, channels, 3,
                                                  dtype=dtype))

    def forward(self, enc_feat, dec_feat, w: float = 1.0):
        h = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))

        def mlp(name):
            z = F.leaky_relu(getattr(self, f"{name}_conv1")(h), 0.2)
            return getattr(self, f"{name}_conv2")(z)

        return dec_feat + w * (dec_feat * mlp("scale") + mlp("shift"))


@register_model("codeformer")
class CodeFormer(nn.Module):
    """Full CodeFormer (codeformer.py:600-753). ``forward(x, w, adain,
    code_only)`` takes (B, 3, S, S) in [-1, 1], S = √latent_size ·
    2^(len(ch_mult)-1) (512 at the defaults), and returns (out (B, 3, S, S),
    logits (B, latent_size, codebook_size), lq_feat (B, 256, √L, √L)); with
    ``code_only``, (logits, lq_feat)."""

    def __init__(self, dim_embd: int = 512, n_head: int = 8, n_layers: int = 9,
                 codebook_size: int = 1024, latent_size: int = 256,
                 connect_list: Sequence[str] = ("32", "64", "128", "256"),
                 nf: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 dtype=torch.float32):
        super().__init__()
        emb_dim = 256       # the flax encoder's default latent width
        self.latent_hw = math.isqrt(latent_size)
        resolution = self.latent_hw * 2 ** (len(ch_mult) - 1)
        self.connect_list = tuple(connect_list)
        self.encoder = CFEncoder(nf=nf, emb_dim=emb_dim, ch_mult=ch_mult,
                                 resolution=resolution, dtype=dtype)
        self.position_emb = nn.Parameter(torch.zeros(latent_size, dim_embd))
        self.feat_emb = Dense(emb_dim, dim_embd, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"ft_layer{i}", TransformerSALayer(
                dim_embd, n_head, dim_embd * 2, dtype))
        self.n_layers = n_layers
        self.idx_norm = LayerNorm(dim_embd)
        self.idx_pred = Dense(dim_embd, codebook_size, use_bias=False,
                              dtype=dtype)
        self.quantize = VectorQuantizer(codebook_size, emb_dim)
        for f in self.connect_list:
            level = int(math.log2(resolution // int(f)))
            self.add_module(f"fuse_{f}",
                            FuseSFTBlock(nf * ch_mult[level], dtype))
        self.generator = CFGenerator(nf=nf, emb_dim=emb_dim, ch_mult=ch_mult,
                                     resolution=resolution, dtype=dtype)

    def random_init(self, seed: int = 0, scale: float = 0.02) -> None:
        random_init_(self, seed, scale)

    def forward(self, x, w: float = 0.0, adain: bool = False,
                code_only: bool = False):
        b = x.shape[0]
        lq_feat, enc_feats = self.encoder(x)
        q = self.feat_emb(lq_feat.flatten(2).transpose(1, 2))  # (B, L, E)
        pos = self.position_emb[None].to(q.dtype)
        for i in range(self.n_layers):
            q = getattr(self, f"ft_layer{i}")(q, query_pos=pos)
        logits = self.idx_pred(self.idx_norm(q))
        if code_only:
            return logits, lq_feat
        hw = self.latent_hw
        quant_feat = self.quantize.get_codebook_feat(
            torch.argmax(logits, dim=-1), (b, hw, hw, lq_feat.shape[1]))
        quant_feat = quant_feat.permute(0, 3, 1, 2).to(lq_feat.dtype)
        if adain:
            quant_feat = adaptive_instance_normalization(quant_feat, lq_feat)

        def fuse_fn(res, feat):
            if res in self.connect_list and w > 0:
                return getattr(self, f"fuse_{res}")(enc_feats[res], feat, w)
            return feat

        return self.generator(quant_feat, fuse_fn=fuse_fn), logits, lq_feat


@register_model("vqautoencoder")
class VQAutoEncoder(nn.Module):
    """Plain VQ-GAN autoencoder (codeformer.py:357-434) for
    (B, 3, img_size, img_size) inputs; returns (out, loss, stats)."""

    def __init__(self, nf: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 codebook_size: int = 1024, emb_dim: int = 256,
                 quantizer: str = "nearest", img_size: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = CFEncoder(nf=nf, emb_dim=emb_dim, ch_mult=ch_mult,
                                 resolution=img_size, dtype=dtype)
        if quantizer == "nearest":
            self.quantize = VectorQuantizer(codebook_size, emb_dim)
        elif quantizer == "gumbel":
            self.quantize = GumbelQuantizer(codebook_size, emb_dim)
        else:
            raise ValueError(f"unknown quantizer: {quantizer!r}")
        self.generator = CFGenerator(nf=nf, emb_dim=emb_dim, ch_mult=ch_mult,
                                     resolution=img_size, dtype=dtype)

    def forward(self, x):
        z, _ = self.encoder(x)
        z_q, loss, stats = self.quantize(z)
        return self.generator(z_q), loss, stats
