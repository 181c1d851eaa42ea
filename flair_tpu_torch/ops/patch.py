"""Spatio-temporal tiling with an overlap merge.

Counterpart of ``flair_tpu/ops/patch.py`` (the reference's patchify /
unpatchify, nn.py:26-338): blocks on a static grid over (T, H, W) of a
(B, T, H, W, C) video after symmetric padding, processed one by one and
merged back with one of the reference's merge modes. Padding follows
``jnp.pad``'s rules at any size (``reflect`` repeats with period 2(n-1)).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .blur import reflect_indices


def _grid_starts(size: int, block: int, stride: int) -> list[int]:
    """Start offsets of each block after symmetric padding to a full grid."""
    n = max(0, math.ceil((size - block) / stride))
    return [i * stride for i in range(n + 1)]


def _padding(size: int, block: int, stride: int) -> tuple[int, int]:
    pad = (math.ceil(max(0, size - block) / stride) * stride + block - size) / 2
    return math.ceil(pad), math.floor(pad)


def _pad(x: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """Pad axes 1-3 of (B, T, H, W, C) by ``pads`` ((before, after) each)."""
    if mode == "constant":
        flat = [p for pair in reversed(pads) for p in pair]
        return F.pad(x, [0, 0] + flat)
    for dim, (p0, p1) in zip((1, 2, 3), pads):
        n = x.shape[dim]
        if mode == "edge":
            idx = np.clip(np.arange(-p0, n + p1), 0, n - 1)
        elif mode == "reflect":
            p = max(p0, p1)
            idx = reflect_indices(n, p)[p - p0:p + n + p1]
        else:
            raise KeyError(mode)
        x = x.index_select(dim, torch.as_tensor(idx, device=x.device))
    return x


def patchify(x: torch.Tensor, block_size: Sequence[int],
             stride: Sequence[int], padding_mode: str = "constant"):
    """Split (B, T, H, W, C) into overlapping blocks (nn.py:26-63).

    Returns (blocks (N, B, bt, bh, bw, C), meta), meta holding the grid
    :func:`unpatchify` needs."""
    b, t, h, w, c = x.shape
    pads = tuple(_padding(n, bs, st)
                 for n, bs, st in zip((t, h, w), block_size, stride))
    xp = _pad(x, pads, padding_mode)
    ts, hs, ws = (_grid_starts(xp.shape[i + 1], block_size[i], stride[i])
                  for i in range(3))
    bt, bh, bw = block_size
    blocks = [xp[:, tt:tt + bt, hh:hh + bh, ww:ww + bw]
              for tt in ts for hh in hs for ww in ws]
    meta = dict(orig_shape=(b, t, h, w, c), padded_shape=tuple(xp.shape),
                pads=pads, starts=(ts, hs, ws), block_size=tuple(block_size),
                stride=tuple(stride))
    return torch.stack(blocks), meta


def _linear_ramp(block: int, overlap: int) -> np.ndarray:
    """Feathering weight along one axis: a linear ramp over the overlap."""
    wgt = np.ones(block, dtype=np.float32)
    if overlap > 0:
        ramp = (np.arange(overlap, dtype=np.float32) + 1) / (overlap + 1)
        wgt[:overlap] = ramp
        wgt[-overlap:] = ramp[::-1]
    return wgt


def _mid_mask(shape, idx, counts, trims) -> np.ndarray:
    """``mid`` merge: a block keeps its interior, trimmed by half the
    overlap on every side that has a neighbour."""
    m = np.ones((1,) + tuple(shape) + (1,), dtype=np.float32)
    for axis, (i, n, o) in enumerate(zip(idx, counts, trims)):
        if o <= 0:
            continue
        sl = [slice(None)] * 5
        if i != 0:
            sl[axis + 1] = slice(0, o)
            m[tuple(sl)] = 0
        if i != n - 1:
            sl[axis + 1] = slice(shape[axis] - o, None)
            m[tuple(sl)] = 0
    return m


def unpatchify(blocks: torch.Tensor, meta: dict,
               merge: str = "mean") -> torch.Tensor:
    """Merge processed blocks back (nn.py:66-338 merge modes).

    merge ∈ {'mean', 'linear', 'mid', 'max', 'min'}:
    - mean:    overlaps averaged (sum / count);
    - linear:  feathered blend, linear ramps over the overlaps;
    - mid:     each pixel from the block whose centre is nearest (half the
               overlap trimmed from every inner side);
    - max/min: elementwise extremum over the blocks covering a pixel."""
    b, t, h, w, c = meta["orig_shape"]
    ts, hs, ws = meta["starts"]
    bt, bh, bw = meta["block_size"]
    st, sh, sw = meta["stride"]
    (pt0, _), (ph0, _), (pw0, _) = meta["pads"]
    dev, dt = blocks.device, blocks.dtype
    grid = [(tt, hh, ww, (ti, hi, wi)) for ti, tt in enumerate(ts)
            for hi, hh in enumerate(hs) for wi, ww in enumerate(ws)]

    def region(v, tt, hh, ww):
        return v[:, tt:tt + bt, hh:hh + bh, ww:ww + bw]

    if merge in ("max", "min"):
        op = torch.maximum if merge == "max" else torch.minimum
        out = torch.full(meta["padded_shape"],
                         -math.inf if merge == "max" else math.inf,
                         dtype=dt, device=dev)
        for blk, (tt, hh, ww, _) in zip(blocks, grid):
            cur = region(out, tt, hh, ww)
            cur.copy_(op(cur.clone(), blk))
        return out[:, pt0:pt0 + t, ph0:ph0 + h, pw0:pw0 + w]

    if merge == "linear":
        wgt = (_linear_ramp(bt, bt - st)[:, None, None]
               * _linear_ramp(bh, bh - sh)[None, :, None]
               * _linear_ramp(bw, bw - sw)[None, None, :])
        weight_block = torch.as_tensor(wgt, dtype=dt, device=dev)[None, ..., None]
    else:
        weight_block = torch.ones((1, bt, bh, bw, 1), dtype=dt, device=dev)
    trims = ((bt - st) // 2, (bh - sh) // 2, (bw - sw) // 2)
    counts = (len(ts), len(hs), len(ws))
    acc = torch.zeros(meta["padded_shape"], dtype=dt, device=dev)
    den = torch.zeros(meta["padded_shape"], dtype=dt, device=dev)
    for blk, (tt, hh, ww, idx) in zip(blocks, grid):
        wb = weight_block
        if merge == "mid":
            wb = torch.as_tensor(_mid_mask((bt, bh, bw), idx, counts, trims),
                                 dtype=dt, device=dev)
        upd = region(acc, tt, hh, ww)
        upd.copy_(upd + blk * wb)
        dupd = region(den, tt, hh, ww)
        dupd.copy_(dupd + wb)
    out = acc / torch.clamp(den, min=1e-8)
    return out[:, pt0:pt0 + t, ph0:ph0 + h, pw0:pw0 + w]


def process_patched(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
                    block_size: Sequence[int], stride: Sequence[int],
                    merge: str = "mean",
                    padding_mode: str = "constant") -> torch.Tensor:
    """patchify → ``fn`` on each block in turn (bounded memory) →
    unpatchify."""
    blocks, meta = patchify(x, block_size, stride, padding_mode)
    return unpatchify(torch.stack([fn(blk) for blk in blocks]), meta, merge)
