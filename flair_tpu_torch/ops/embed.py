"""Timestep / noise-level embeddings (nn.py:863-881, sr3.py:45-61).

Counterpart of ``flair_tpu/ops/embed.py``."""

from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """ADM sinusoidal embedding cat([cos, sin]) of geometric frequencies.
    ``timesteps`` (N,), possibly fractional → (N, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def sr3_noise_embedding(noise_level: torch.Tensor, dim: int) -> torch.Tensor:
    """WaveGrad/SR3 continuous noise-level encoding cat([sin, cos]) of
    noise_level·exp(-ln(1e4)·k/half) (sr3.py:45-61); note the sin/cos order
    differs from the ADM embedding. (N,) → (N, dim) float32."""
    count = dim // 2
    step = torch.arange(count, dtype=torch.float32,
                        device=noise_level.device) / count
    enc = noise_level.float()[:, None] * torch.exp(-math.log(1e4) * step[None])
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)
