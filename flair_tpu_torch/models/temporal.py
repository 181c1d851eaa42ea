"""Temporal attention and the temporal gating wrapper.

Counterpart of ``flair_tpu/models/temporal.py``:
- ``TemporalAttention`` (unet.py:664-758): each frame attends per pixel to
  its ≤F-1 neighbours with sinusoidal relative-position embeddings, folded
  into the projections by linearity (``ops.attention``), no unfold.
- ``TemporalWrapper2`` (sr3.py:203-226): sigmoid mix of a wrapped module's
  output and its input, driven by a zero-init linear of the embedding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops.attention import temporal_window_attention
from .common import Conv2d, Dense, GroupNorm32, ShiftWindowGroupNorm, nchw, nhwc, silu


def _relative_embedding(f: int, c: int) -> np.ndarray:
    """timestep_embedding(arange(F) - F//2, C) as float32 numpy."""
    rel = (np.arange(f) - f // 2).astype(np.float64)
    half = c // 2
    freqs = np.exp(-math.log(10000.0) * np.arange(half) / half)
    args = rel[:, None] * freqs[None]
    emb = np.concatenate([np.cos(args), np.sin(args)], axis=-1)
    if c % 2:
        emb = np.concatenate([emb, np.zeros_like(emb[:, :1])], axis=-1)
    return emb.astype(np.float32)


class TemporalAttention(nn.Module):
    """Windowed centre-frame temporal attention; returns x + zero-init
    projection of the attention output."""

    def __init__(self, channels: int, num_frames: int = 5, num_heads: int = 1,
                 num_head_channels: int = -1, norm_type: str = "group_norm",
                 dtype=torch.float32):
        super().__init__()
        assert num_frames % 2 == 1, "num_frames must be odd"
        c = channels
        self.num_frames = num_frames
        self.heads = num_heads if num_head_channels == -1 else c // num_head_channels
        self.dtype = dtype
        if norm_type == "group_norm":
            self.norm = GroupNorm32(c, 32)
        elif norm_type == "shift_window_norm":
            self.norm = ShiftWindowGroupNorm(c, num_frames, 32)
        else:
            self.norm = None
        self.q_linear = Dense(c, c, dtype=dtype)
        self.k_linear = Dense(c, c, dtype=dtype)
        self.v_linear = Dense(c, c, dtype=dtype)
        self.proj = Conv2d(c, c, 1, zero_init=True, dtype=dtype)
        emb = _relative_embedding(num_frames, c)
        self.register_buffer("t_mid", torch.from_numpy(emb[num_frames // 2]),
                             persistent=False)
        self.register_buffer(
            "t_rest", torch.from_numpy(np.delete(emb, num_frames // 2, 0)),
            persistent=False)

    def forward(self, x, b: int):
        n, c, hh, ww = x.shape
        dt = self.dtype
        h = x if self.norm is None else self.norm(x, b)
        hv = nhwc(h)                                    # (N, H, W, C)
        q = self.q_linear(hv + self.t_mid.to(dt))
        k = self.k_linear(hv)
        v = self.v_linear(hv)
        zero = torch.zeros((1, c), dtype=dt, device=x.device)
        k_pos = self.k_linear(self.t_rest.to(dt)) - self.k_linear(zero)
        five = lambda a: a.reshape(b, n // b, hh, ww, c)  # noqa: E731
        out = temporal_window_attention(five(q), five(k), five(v), k_pos,
                                        self.num_frames, self.heads)
        return x + self.proj(nchw(out.reshape(n, hh, ww, c)))


class TemporalWrapper2(nn.Module):
    """Per-(frame, channel) sigmoid gate: (1 − s)·x + s·out with
    s = sigmoid(gate(silu(emb))), gate zero-initialised."""

    def __init__(self, features: int, emb_dim: int, dtype=torch.float32):
        super().__init__()
        self.gate = Dense(emb_dim, features, zero_init=True, dtype=dtype)

    def forward(self, x, out, emb):
        w = self.gate(silu(emb))[:, :, None, None]      # (N, C, 1, 1)
        s = torch.sigmoid(w.float()).to(x.dtype)
        return (1 - s) * x + s * out
