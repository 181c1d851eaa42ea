"""Plain attention and windowed temporal attention.

Counterpart of ``dot_product_attention`` and ``temporal_window_attention``
in ``flair_tpu/ops/attention.py``. The JAX package's Pallas flash kernel
(``_flash_kernel``) serves the BlurUNet only and is not part of this
package yet.

Temporal window attention never materialises the reference's 7x
``unfold``: Q/K/V are projected per frame, the per-window-position key
embedding is added in projected space, and each centre frame attends to its
F-1 neighbours through clamped frame indices (replicate padding).
"""

from __future__ import annotations

import math

import torch


def dot_product_attention(q, k, v, scale: float | None = None):
    """Attention over (B, S, H, D) tensors; softmax in float32."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def temporal_window_attention(q_center, k_frames, v_frames, k_pos,
                              num_frames: int, num_heads: int):
    """Sliding-window centre-frame attention (unet.py:712-758).

    q_center, k_frames, v_frames: (B, T, H, W, C) per-frame projections
    (the query already holds its position term; keys do not). k_pos:
    (F-1, C) per-window-position key terms. num_frames F is odd; frame
    indices clamp at clip edges. Returns (B, T, H, W, C) in q's dtype."""
    b, t, hh, ww, c = q_center.shape
    half = num_frames // 2
    dh = c // num_heads
    scale = 1.0 / math.sqrt(dh)
    qh = q_center.reshape(b, t, hh, ww, num_heads, dh).float()
    offsets = [o for o in range(-half, half + 1) if o != 0]
    t_idx = torch.arange(t, device=q_center.device)
    logits, vals = [], []
    for j, o in enumerate(offsets):
        src = torch.clamp(t_idx + o, 0, t - 1)
        kj = k_frames.index_select(1, src) + k_pos[j].to(k_frames.dtype)
        vj = v_frames.index_select(1, src)
        kjh = kj.reshape(b, t, hh, ww, num_heads, dh).float()
        logits.append((qh * kjh).sum(-1) * scale)
        vals.append(vj.reshape(b, t, hh, ww, num_heads, dh))
    probs = torch.softmax(torch.stack(logits, dim=-1), dim=-1)
    out = torch.zeros_like(qh)
    for j in range(len(offsets)):
        out = out + probs[..., j:j + 1] * vals[j].float()
    return out.reshape(b, t, hh, ww, c).to(q_center.dtype)
