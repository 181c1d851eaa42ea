"""Plain float32 layers of the frozen reference (no kernels, no cache).

A frozen copy of the semantics of FLAIR's layers (arXiv 2311.15445; the
SR3 and ADM video UNets of wustl-cig/FLAIR), written for clarity and kept
apart from the program under test: it imports nothing of it. Activations
are (B·T, C, H, W) float32 NCHW; ``b`` is the clip count B. Parameter names
and shapes follow the measured program's, so one seeded draw by name feeds
both sides.

Every matrix product goes through ``Layer.q``: identity for the reference,
and a rounding of both operands to a lower precision for the control (see
``set_precision``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one per-tensor scale (amax → 448)."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Layer(nn.Module):
    """A module whose matrix-product operands pass through ``q``."""

    rounding = None

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rounding is None else self.rounding(x)


def set_precision(model: nn.Module, lower: bool) -> None:
    """The control: every product's operands rounded one precision below
    the one the configuration states, float8 e4m3 where the program runs
    bf16 and bf16 where it runs float32 (``model.FLOAT32_PARTS``, by name
    prefix). ``lower=False`` restores the float32 reference."""
    f32 = tuple(getattr(model, "FLOAT32_PARTS", ()))
    for name, m in model.named_modules():
        if isinstance(m, Layer):
            if not lower:
                m.rounding = None
            elif name.startswith(f32):
                m.rounding = round_bf16
            else:
                m.rounding = round_fp8


def _param(*shape):
    return nn.Parameter(torch.empty(shape))


class Conv2d(Layer):
    def __init__(self, cin, cout, k=3, stride=1, padding=None, bias=True):
        super().__init__()
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None
        self.stride = stride
        self.padding = k // 2 if padding is None else padding

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias,
                        self.stride, self.padding)


class Conv3d(Layer):
    """A conv over (T, H, W) of (B·T, C, H, W), zero-padded by k // 2."""

    def __init__(self, cin, cout, k=(3, 3, 3)):
        super().__init__()
        self.weight = _param(cout, cin, *k)
        self.bias = _param(cout)

    def forward(self, x, b):
        n, c, h, w = x.shape
        v = x.reshape(b, n // b, c, h, w).transpose(1, 2)
        pad = tuple(k // 2 for k in self.weight.shape[2:])
        y = F.conv3d(self.q(v), self.q(self.weight), self.bias, padding=pad)
        return y.transpose(1, 2).reshape(n, -1, h, w)


class Dense(Layer):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = _param(cout, cin)
        self.bias = _param(cout) if bias else None

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm with gcd(groups, C) groups, its statistics joint over the
    frames of each clip; eps 1e-5."""

    def __init__(self, channels, groups=32):
        super().__init__()
        self.groups = math.gcd(groups, channels)
        self.weight = _param(channels)
        self.bias = _param(channels)

    def forward(self, x, b):
        n, c, h, w = x.shape
        v = x.reshape(b, n // b, c, h, w).transpose(1, 2)
        y = F.group_norm(v, self.groups, self.weight, self.bias, 1e-5)
        return y.transpose(1, 2).reshape(n, c, h, w)


def attention(q, k, v, scale, q_fn):
    """softmax(q·kᵀ·scale)·v over (N, S, heads, D), with each product's
    operands through ``q_fn``."""
    logits = torch.einsum("nqhd,nkhd->nhqk", q_fn(q), q_fn(k)) * scale
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", q_fn(p), q_fn(v))


def timestep_embedding(t, dim, max_period=10000.0):
    """ADM: cat([cos, sin]) of t·exp(-ln(max_period)·i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def noise_level_embedding(level, dim):
    """SR3 / WaveGrad: cat([sin, cos]) of level·exp(-ln(1e4)·i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(1e4)
                      * torch.arange(half, device=level.device) / half)
    enc = level.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


class ResBlock(nn.Module):
    """ADM residual block; ``dims=3`` convolves over (T, H, W) with
    ``kernel``; ``up`` / ``down`` resample by nearest 2× / 2×2 mean."""

    def __init__(self, cin, cout, emb, *, scale_shift=False, dims=2,
                 kernel=(3, 3, 3), up=False, down=False):
        super().__init__()
        self.scale_shift, self.up, self.down, self.dims = (
            scale_shift, up, down, dims)
        self.in_norm = GroupNorm(cin)
        self.in_conv = Conv3d(cin, cout, kernel) if dims == 3 else Conv2d(
            cin, cout)
        self.emb_proj = Dense(emb, 2 * cout if scale_shift else cout)
        self.out_norm = GroupNorm(cout)
        self.out_conv = Conv3d(cout, cout, kernel) if dims == 3 else Conv2d(
            cout, cout)
        self.skip = Conv2d(cin, cout, 1) if cin != cout else None

    def conv(self, m, x, b):
        return m(x, b) if self.dims == 3 else m(x)

    def forward(self, x, emb, b):
        h = F.silu(self.in_norm(x, b))
        if self.up:
            h, x = (F.interpolate(v, scale_factor=2.0, mode="nearest")
                    for v in (h, x))
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.conv(self.in_conv, h, b)
        e = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_norm(h, b) * (1 + scale) + shift
        else:
            h = self.out_norm(h + e, b)
        h = self.conv(self.out_conv, F.silu(h), b)
        return (x if self.skip is None else self.skip(x)) + h


class AttentionBlock(Layer):
    """ADM spatial self-attention: the packed qkv split per head
    (N, S, heads, 3, D), scale 1/√D; ``emb_dim`` makes it the bottleneck
    block, which adds emb_proj(silu(emb)) before the projection.
    ``record``: a list that collects (N·heads, S, D) of each call."""

    record = None

    def __init__(self, c, head_channels, emb_dim=None):
        super().__init__()
        self.heads = c // head_channels
        self.norm = GroupNorm(c)
        self.qkv = Dense(c, 3 * c)
        self.proj = Dense(c, c)
        if emb_dim is not None:
            self.emb_proj = Dense(emb_dim, c)

    def forward(self, x, b, emb=None):
        n, c, h, w = x.shape
        t = self.norm(x, b).permute(0, 2, 3, 1).reshape(n, h * w, c)
        q, k, v = self.qkv(t).reshape(n, h * w, self.heads, 3, -1).unbind(3)
        if self.record is not None:
            self.record.append((n * self.heads, h * w, q.shape[-1]))
        out = attention(q, k, v, q.shape[-1] ** -0.5, self.q).reshape(
            n, h * w, c)
        if emb is not None:
            out = out + self.emb_proj(F.silu(emb))[:, None, :]
        out = self.proj(out)
        return x + out.reshape(n, h, w, c).permute(0, 3, 1, 2)


class TemporalAttention(Layer):
    """Each frame attends, per pixel and head, to the F−1 other frames of
    an F-frame window centred on it (clip ends replicated). A sinusoidal
    embedding of the relative position is added to the query's input (0)
    and to each key's input; values carry none."""

    def __init__(self, c, frames, head_channels):
        super().__init__()
        self.frames, self.heads = frames, c // head_channels
        self.norm = GroupNorm(c)
        self.q_linear, self.k_linear, self.v_linear = (
            Dense(c, c) for _ in range(3))
        self.proj = Conv2d(c, c, 1)

    def forward(self, x, b):
        n, c, hh, ww = x.shape
        t, half = n // b, self.frames // 2
        rel = torch.arange(-half, half + 1, device=x.device).float()
        pos = timestep_embedding(rel, c)                 # (F, C)
        h = self.norm(x, b).permute(0, 2, 3, 1).reshape(b, t, hh, ww, c)
        q = self.q_linear(h + pos[half])
        logits, values = [], []
        for j, o in enumerate(range(-half, half + 1)):
            if o == 0:
                continue
            src = (torch.arange(t, device=x.device) + o).clamp(0, t - 1)
            k = self.k_linear(h[:, src] + pos[j])
            values.append(self.v_linear(h[:, src]))
            prod = self.q(q).reshape(*q.shape[:4], self.heads, -1) * self.q(
                k).reshape(*k.shape[:4], self.heads, -1)
            logits.append(prod.sum(-1) / math.sqrt(c // self.heads))
        p = torch.softmax(torch.stack(logits, -1), dim=-1)
        out = sum(self.q(p[..., j:j + 1]) * self.q(v).reshape(
            *v.shape[:4], self.heads, -1) for j, v in enumerate(values))
        out = out.reshape(n, hh, ww, c).permute(0, 3, 1, 2)
        return x + self.proj(out)


class Gate(nn.Module):
    """(1 − s)·x + s·out with s = sigmoid(gate(silu(emb))) per frame and
    channel."""

    def __init__(self, c, emb):
        super().__init__()
        self.gate = Dense(emb, c)

    def forward(self, x, out, emb):
        s = torch.sigmoid(self.gate(F.silu(emb)))[:, :, None, None]
        return (1 - s) * x + s * out


def flow_warp(x, fx, fy, padding_mode="zeros"):
    """Sample (N, C, H, W) at (col + fx, row + fy), bilinear; fx, fy
    (N, H, W) in pixels."""
    n, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device).float(),
                            torch.arange(w, device=x.device).float(),
                            indexing="ij")
    grid = torch.stack([2 * (gx + fx) / max(w - 1, 1) - 1,
                        2 * (gy + fy) / max(h - 1, 1) - 1], dim=-1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding_mode,
                         align_corners=True)
