"""CodeFormer, plain float32 (Zhou et al., NeurIPS 2022, arXiv 2206.11253;
sczhou/CodeFormer ``basicsr/archs/codeformer_arch.py`` and
``vqgan_arch.py``): the VQ-GAN encoder, a pre-LN transformer that predicts
a codebook index for each latent token, the codebook lookup, AdaIN of the
looked-up codes to the encoder's latent, and the VQ-GAN generator with SFT
fusion of the encoder's features at the ``connect_list`` resolutions.

``forward(x, w, adain, codes=None)`` takes (N, 3, S, S) faces in [-1, 1]
and returns (out (N, 3, S, S), logits (N, L, codebook), latent): ``codes``
(N, L), where given, take the place of the logits' own argmax, so that the
generator can be judged on the codes another implementation chose.

Every product (convs, dense layers, both attention products) goes through
``nn.Layer.q``, so that ``nn.set_precision`` rounds it for the control;
GroupNorm, LayerNorm, AdaIN and the lookup stay float32.

Departures from the upstream code, each as the measured program has it:
module and parameter names follow the flax scopes of the JAX port
(``encoder.block3.norm1``, ``ft_layer0.self_attn.query``, ``idx_pred``,
``fuse_64.scale_conv1``), so one seeded draw by name feeds both sides; the
transformer's attention has separate query / key / value / out projections
(upstream packs q, k and v into one ``in_proj``); LayerNorm's eps is 1e-6
(flax's; upstream's torch default is 1e-5); AdaIN takes the population
variance (upstream ``var`` is the unbiased one); the argmax of the logits
picks the code where upstream takes the top-1 of their softmax (the same
index); the encoder and generator are built for the resolution that
``latent_size`` and ``ch_mult`` give. The codebook holds only the lookup
that CodeFormer's forward uses.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import Conv2d, Dense, Layer, _param, attention


class GNorm(nn.Module):
    """GroupNorm(32 groups, eps 1e-6, affine) of one image, float32."""

    def __init__(self, channels):
        super().__init__()
        self.weight = _param(channels)
        self.bias = _param(channels)

    def forward(self, x):
        return F.group_norm(x, 32, self.weight, self.bias, 1e-6)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-6, float32."""

    def __init__(self, dim):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, 1e-6)


class ResBlock(nn.Module):
    """norm → swish → 3×3 conv, twice, plus the input (a 1×1 conv of it
    where the channels change)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GNorm(cin)
        self.conv1 = Conv2d(cin, cout)
        self.norm2 = GNorm(cout)
        self.conv2 = Conv2d(cout, cout)
        self.conv_out = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_out is None else self.conv_out(x)) + h


class AttnBlock(nn.Module):
    """Single-head attention over the pixels, 1×1 convs for q, k, v and
    the output, scale 1/√C. The two products take the rounding of the
    parameterless ``product`` (the convs' names leave ``Layer.q`` no
    room)."""

    def __init__(self, c):
        super().__init__()
        self.norm = GNorm(c)
        self.q, self.k, self.v, self.proj_out = (Conv2d(c, c, 1)
                                                 for _ in range(4))
        self.product = Layer()

    def forward(self, x):
        n, c, h, w = x.shape
        t = self.norm(x)

        def tokens(conv):  # (N, HW, 1, C)
            return conv(t).flatten(2).transpose(1, 2)[:, :, None]

        out = attention(tokens(self.q), tokens(self.k), tokens(self.v),
                        c ** -0.5, self.product.q)
        return x + self.proj_out(out[:, :, 0].transpose(1, 2).reshape(
            n, c, h, w))


class Downsample(nn.Module):
    """Zero pad right and bottom by one, then a 3×3 conv of stride 2."""

    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv."""

    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def add_block(module, plan, name, block, res, j=None):
    module.add_module(name, block)
    plan.append((name, res, j))


class Encoder(nn.Module):
    """conv_in, the levels (two res blocks each, attention at 16², a
    stride-2 conv between levels), res / attention / res, norm, conv_out
    to ``emb_dim``. Returns (latent, {resolution: the feature after its
    level's last res block})."""

    def __init__(self, nf, emb_dim, ch_mult, res, attn_res=(16,)):
        super().__init__()
        self.conv_in = Conv2d(3, nf)
        self.plan = []      # (module name, its level's resolution, j)
        ch, li = nf, 0
        for i, mult in enumerate(ch_mult):
            for j in range(2):
                add_block(self, self.plan, f"block{li}",
                          ResBlock(ch, nf * mult), res, j)
                ch, li = nf * mult, li + 1
                if res in attn_res:
                    add_block(self, self.plan, f"attn{li}", AttnBlock(ch),
                              res)
                    li += 1
            if i != len(ch_mult) - 1:
                add_block(self, self.plan, f"down{i}", Downsample(ch), res)
                res //= 2
        self.mid_block1 = ResBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block2 = ResBlock(ch, ch)
        self.norm_out = GNorm(ch)
        self.conv_out = Conv2d(ch, emb_dim)

    def forward(self, x):
        feats = {}
        x = self.conv_in(x)
        for name, res, j in self.plan:
            x = getattr(self, name)(x)
            if j == 1:
                feats[str(res)] = x
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        return self.conv_out(self.norm_out(x)), feats


class Generator(nn.Module):
    """conv_in from ``emb_dim``, res / attention / res, the levels from
    the deepest up (nearest ×2 and a conv between levels), norm, conv_out
    to RGB. ``fuse(res, x)`` follows the deepest level's last res block
    and every other level's first (codeformer_arch.py's
    ``fuse_generator_block``)."""

    def __init__(self, nf, emb_dim, ch_mult, res, attn_res=(16,)):
        super().__init__()
        ch = nf * ch_mult[-1]
        res //= 2 ** (len(ch_mult) - 1)
        self.conv_in = Conv2d(emb_dim, ch)
        self.mid_block1 = ResBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block2 = ResBlock(ch, ch)
        self.plan = []      # (module name, its level's resolution, fuse)
        li, deepest = 0, len(ch_mult) - 1
        for i in reversed(range(len(ch_mult))):
            for j in range(2):
                add_block(self, self.plan, f"block{li}",
                          ResBlock(ch, nf * ch_mult[i]), res,
                          j == 1 if i == deepest else j == 0)
                ch, li = nf * ch_mult[i], li + 1
                if res in attn_res:
                    add_block(self, self.plan, f"attn{li}", AttnBlock(ch),
                              res)
                    li += 1
            if i != 0:
                add_block(self, self.plan, f"up{i}", Upsample(ch), res)
                res *= 2
        self.norm_out = GNorm(ch)
        self.conv_out = Conv2d(ch, 3)

    def forward(self, x, fuse):
        x = self.conv_in(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        for name, res, fused in self.plan:
            x = getattr(self, name)(x)
            if fused:
                x = fuse(str(res), x)
        return self.conv_out(self.norm_out(x))


class SelfAttention(Layer):
    """Multi-head self-attention: query / key / value / out projections,
    softmax(q·kᵀ/√D)·v per head; q and k from ``qk``, v from ``v``."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (Dense(dim, dim)
                                                      for _ in range(4))

    def forward(self, qk, v):
        n, s, e = qk.shape

        def split(t):
            return t.reshape(n, s, self.heads, e // self.heads)

        o = attention(split(self.query(qk)), split(self.key(qk)),
                      split(self.value(v)), (e // self.heads) ** -0.5, self.q)
        return self.out(o.reshape(n, s, e))


class TransformerLayer(nn.Module):
    """Pre-LN: x + attn(norm1 x, the position added to q and k), then
    x + linear2(gelu(linear1(norm2 x)))."""

    def __init__(self, dim, heads, mlp):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.self_attn = SelfAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.linear1 = Dense(dim, mlp)
        self.linear2 = Dense(mlp, dim)

    def forward(self, x, pos):
        h = self.norm1(x)
        x = x + self.self_attn(h + pos, h)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class Codebook(nn.Module):
    """The codebook (codebook_size × emb_dim) and its lookup."""

    def __init__(self, size, dim):
        super().__init__()
        self.embedding = _param(size, dim)

    def lookup(self, codes):
        return self.embedding[codes]


class FuseSFT(nn.Module):
    """SFT fusion: h = res(cat(enc, dec)); dec + w·(dec·scale(h) +
    shift(h)), each of scale and shift conv → leaky 0.2 → conv."""

    def __init__(self, c):
        super().__init__()
        self.encode_enc = ResBlock(2 * c, c)
        for name in ("scale", "shift"):
            setattr(self, f"{name}_conv1", Conv2d(c, c))
            setattr(self, f"{name}_conv2", Conv2d(c, c))

    def forward(self, enc, dec, w):
        h = self.encode_enc(torch.cat([enc, dec], 1))

        def mlp(name):
            z = F.leaky_relu(getattr(self, f"{name}_conv1")(h), 0.2)
            return getattr(self, f"{name}_conv2")(z)

        return dec + w * (dec * mlp("scale") + mlp("shift"))


def mean_std(x, eps=1e-5):
    """Each channel's spatial mean and √(population variance + eps)."""
    mean = x.mean((2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((2, 3), keepdim=True)
    return mean, torch.sqrt(var + eps)


def adaptive_instance_norm(content, style):
    """``content`` given the channel statistics of ``style``."""
    c_mean, c_std = mean_std(content)
    s_mean, s_std = mean_std(style)
    return (content - c_mean) / c_std * s_std + s_mean


class CodeFormer(nn.Module):
    """The whole network at CodeFormer's published sizes by default:
    512² faces, nf 64, ch_mult (1, 2, 2, 4, 4, 8), a 16² latent of width
    256, 9 transformer layers of width 512 with 8 heads and an MLP of
    1 024, 1 024 codes, fusion at 32 / 64 / 128 / 256."""

    EMB_DIM = 256

    def __init__(self, dim_embd=512, n_head=8, n_layers=9,
                 codebook_size=1024, latent_size=256,
                 connect_list=("32", "64", "128", "256"), nf=64,
                 ch_mult=(1, 2, 2, 4, 4, 8)):
        super().__init__()
        self.latent_hw = math.isqrt(latent_size)
        res = self.latent_hw * 2 ** (len(ch_mult) - 1)
        self.connect_list = tuple(connect_list)
        self.encoder = Encoder(nf, self.EMB_DIM, ch_mult, res)
        self.position_emb = _param(latent_size, dim_embd)
        self.feat_emb = Dense(self.EMB_DIM, dim_embd)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"ft_layer{i}", TransformerLayer(
                dim_embd, n_head, 2 * dim_embd))
        self.idx_norm = LayerNorm(dim_embd)
        self.idx_pred = Dense(dim_embd, codebook_size, bias=False)
        self.quantize = Codebook(codebook_size, self.EMB_DIM)
        for f in self.connect_list:
            level = int(math.log2(res // int(f)))
            self.add_module(f"fuse_{f}", FuseSFT(nf * ch_mult[level]))
        self.generator = Generator(nf, self.EMB_DIM, ch_mult, res)

    def forward(self, x, w=0.0, adain=False, codes=None):
        n = x.shape[0]
        lq, feats = self.encoder(x)
        q = self.feat_emb(lq.flatten(2).transpose(1, 2))    # (N, L, E)
        for i in range(self.n_layers):
            q = getattr(self, f"ft_layer{i}")(q, self.position_emb)
        logits = self.idx_pred(self.idx_norm(q))
        if codes is None:
            codes = logits.argmax(-1)
        elif codes.shape != logits.shape[:-1]:
            raise ValueError(f"codes {tuple(codes.shape)} for logits "
                             f"{tuple(logits.shape)}")
        hw = self.latent_hw
        quant = self.quantize.lookup(codes).reshape(n, hw, hw, -1).permute(
            0, 3, 1, 2)
        if adain:
            quant = adaptive_instance_norm(quant, lq)

        def fuse(res, h):
            if res in self.connect_list and w > 0:
                return getattr(self, f"fuse_{res}")(feats[res], h, w)
            return h

        return self.generator(quant, fuse), logits, lq
