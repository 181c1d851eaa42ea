"""Pixel shuffle / unshuffle on channels-last tensors.

Counterpart of ``flair_tpu/ops/shuffle.py``: the JAX package's (..., H, W,
C·r²) layout, with ``torch.pixel_shuffle``'s channel order (input channel
(c, ry, rx) → output pixel (ry, rx) of channel c). Reshapes and one permute.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W, C·r²) → (..., H·r, W·r, C)."""
    *lead, h, w, crr = x.shape
    r = factor
    c = crr // (r * r)
    n = len(lead)
    x = x.reshape(*lead, h, w, c, r, r)
    # (..., h, w, c, ry, rx) → (..., h, ry, w, rx, c)
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return x.reshape(*lead, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H·r, W·r, C) → (..., H, W, C·r²), the inverse of
    :func:`pixel_shuffle`."""
    *lead, hr, wr, c = x.shape
    r = factor
    n = len(lead)
    x = x.reshape(*lead, hr // r, r, wr // r, r, c)
    # (..., h, ry, w, rx, c) → (..., h, w, c, ry, rx)
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return x.reshape(*lead, hr // r, wr // r, c * r * r)
