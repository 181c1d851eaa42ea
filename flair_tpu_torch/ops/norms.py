"""Normalisation primitives with float32 statistics.

Counterpart of ``flair_tpu/ops/norms.py`` (reference GroupNorm32,
nn.py:652-654, and ShiftWindowGroupNorm32, nn.py:657-748). Both take
channels-last views (B, ..., C) — for the port's NCHW channels_last
activations that is ``x.permute(0, 2, 3, 1)`` reshaped to (B, T, H, W, C),
a free view — and return the input dtype with statistics, weight and bias
applied in float32.
"""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (B, ..., C): statistics per batch element over every
    remaining dim × (C/G) — for a (B, T, H, W, C) video JOINT over frames,
    the reference's LazyReshaper3D(GroupNorm32) convention."""
    orig_dtype = x.dtype
    xf = x.float()
    shape = xf.shape
    b, c = shape[0], shape[-1]
    xg = xf.reshape(b, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(shape)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(orig_dtype)


def shift_window_group_norm(x: torch.Tensor, num_groups: int, win_size: int,
                            weight=None, bias=None, eps: float = 1e-5,
                            padding_mode: str = "replicate") -> torch.Tensor:
    """Sliding-temporal-window group norm of (B, T, H, W, C): frame t uses
    group statistics pooled over frames [t-p, t+p] (p = win_size // 2),
    replicate- or zero-padded at the clip ends. Per-frame group sums are
    combined by a moving sum over T — no unfold of the activation."""
    assert win_size % 2 == 1, "win_size must be odd"
    orig_dtype = x.dtype
    xf = x.float()
    b, t, h, w, c = xf.shape
    g = num_groups
    p = (win_size - 1) // 2
    xg = xf.reshape(b, t, h, w, g, c // g)
    s1 = xg.sum(dim=(2, 3, 5))  # (B, T, G)
    s2 = (xg * xg).sum(dim=(2, 3, 5))
    n_frame = h * w * (c // g)
    if t == 1:
        mean = s1 / n_frame
        var = s2 / n_frame - mean * mean
    else:
        if padding_mode == "replicate":
            pad1 = torch.cat([s1[:, :1].expand(b, p, g), s1,
                              s1[:, -1:].expand(b, p, g)], 1)
            pad2 = torch.cat([s2[:, :1].expand(b, p, g), s2,
                              s2[:, -1:].expand(b, p, g)], 1)
        elif padding_mode == "zeros":
            z = torch.zeros_like(s1[:, :p])
            pad1 = torch.cat([z, s1, z], 1)
            pad2 = torch.cat([z, s2, z], 1)
        else:
            raise NotImplementedError(padding_mode)
        win1 = sum(pad1[:, i:i + t] for i in range(win_size))
        win2 = sum(pad2[:, i:i + t] for i in range(win_size))
        n = n_frame * win_size
        mean = win1 / n
        var = win2 / n - mean * mean
    mean = mean[:, :, None, None, :, None]
    var = var[:, :, None, None, :, None]
    out = ((xg - mean) * torch.rsqrt(torch.clamp(var, min=0.0) + eps)
           ).reshape(b, t, h, w, c)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(orig_dtype)
