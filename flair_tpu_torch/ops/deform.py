"""Modulated deformable convolution (DCNv2), plain PyTorch.

The plain twin of the CUDA kernel ``csrc/dcn_raw.cu`` (wrapper:
``ops/dcn.py``): the CPU runs and the tests use it, and ``chip_smoke.py``
holds the kernel against it on the card. Counterpart of
``flair_tpu/ops/deform.py`` (``deform_conv2d``, ``modulated_deform_conv2d``)
and of ``flair_tpu/ops/dcn_pallas.py::_materialize_raw``.

Semantics are exact: every bilinear corner outside the image contributes
zero, tested per corner (the CUDA-kernel boundary rule of the reference).

Convention: NHWC activations. ``offset`` is (B, Ho, Wo, G, K, 2) in (dy, dx)
order, ``mask`` (B, Ho, Wo, G, K), ``weight`` (Cout, Cin, kh, kw) — the torch
(OIHW) layout the port keeps its parameters in.
"""

from __future__ import annotations

import torch


def deform_conv2d(x, offset, weight, bias=None, *, mask=None, stride=1,
                  padding=1, dilation=1):
    """(Modulated) deformable conv2d, all taps at once.

    x (B, H, W, Cin); offset (B, Ho, Wo, G, K, 2); weight (Cout, Cin, kh, kw);
    mask optional (B, Ho, Wo, G, K), already sigmoided. Returns
    (B, Ho, Wo, Cout) in x.dtype. Sample coordinates stay float32 whatever
    the value dtype (bf16 cannot resolve pixel positions past 256).
    """
    b, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    g = offset.shape[3]
    ho, wo = offset.shape[1], offset.shape[2]
    kk = kh * kw
    cg = cin // g
    dt = x.dtype
    dev = x.device
    f32 = torch.float32
    taps = torch.arange(kk, device=dev)
    base_y = ((torch.arange(ho, device=dev, dtype=f32) * stride - padding)
              .view(1, ho, 1, 1, 1) + ((taps // kw) * dilation).to(f32))
    base_x = ((torch.arange(wo, device=dev, dtype=f32) * stride - padding)
              .view(1, 1, wo, 1, 1) + ((taps % kw) * dilation).to(f32))
    sy = base_y + offset[..., 0].to(f32)          # (B, Ho, Wo, G, K)
    sx = base_x + offset[..., 1].to(f32)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    # corner validity: zero outside the image, each corner on its own
    # the modulation mask folds into the row weights (one pass less over the
    # sampled values)
    m = 1.0 if mask is None else mask.to(f32)
    wy0 = (1 - fy) * ((y0 >= 0) & (y0 <= h - 1)) * m
    wy1 = fy * ((y0 + 1 >= 0) & (y0 + 1 <= h - 1)) * m
    wx0 = (1 - fx) * ((x0 >= 0) & (x0 <= w - 1))
    wx1 = fx * ((x0 + 1 >= 0) & (x0 + 1 <= w - 1))
    # row of (batch, pixel, group) in xrows = (b·H·W + pixel)·G + g
    xrows = x.reshape(b * h * w * g, cg)
    row0 = (torch.arange(b, device=dev).view(b, 1, 1, 1, 1) * (h * w * g)
            + torch.arange(g, device=dev).view(1, 1, 1, g, 1))

    def corner(yy, xx, wt):
        iy = yy.clamp(0, h - 1).long()
        ix = xx.clamp(0, w - 1).long()
        rows = (row0 + (iy * w + ix) * g).reshape(-1)
        v = xrows.index_select(0, rows).reshape(b, ho, wo, g, kk, cg)
        return v * wt.to(dt)[..., None]

    val = (corner(y0, x0, wy0 * wx0) + corner(y0, x0 + 1, wy0 * wx1)
           + corner(y0 + 1, x0, wy1 * wx0) + corner(y0 + 1, x0 + 1, wy1 * wx1))
    # contract over (group, tap, channel-in-group): channel c = g·cg + j; the
    # weight is permuted to the samples' order, not the samples
    wk = (weight.to(dt).reshape(cout, g, cg, kk).permute(1, 3, 2, 0)
          .reshape(g * kk * cg, cout))
    out = (val.reshape(b, ho * wo, g * kk * cg) @ wk).reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias.to(dt)
    return out


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, **kwargs):
    """DCNv2 (mmcv ModulatedDeformConv2d parity)."""
    return deform_conv2d(x, offset, weight, bias, mask=mask, **kwargs)


def materialize_raw(res_y, res_x, mask_logits, flow_y, flow_x, mrm: float):
    """Raw prep → stacked (B,H,W,G,9,2) offsets + (B,H,W,G,9) mask.

    ``res_*``/``mask_logits`` (B, H, W, G·9) in (group, tap) channel order;
    ``flow_*`` (B, H, W, A) float32 per-anchor flow planes; the first G/A
    groups are anchored on flow 0. ``off = mrm·tanh(res) + flow``,
    ``mask = sigmoid(logits)`` (``_materialize_raw`` in dcn_pallas.py)."""
    bb, hh, ww, gk = res_y.shape
    g = gk // 9
    rep = gk // flow_y.shape[-1]

    def comp(res, flow):
        o = mrm * torch.tanh(res.float())
        o = o + flow.float().repeat_interleave(rep, dim=-1)
        return o.reshape(bb, hh, ww, g, 9)

    off = torch.stack([comp(res_y, flow_y), comp(res_x, flow_x)], dim=-1)
    mask = torch.sigmoid(mask_logits.float()).reshape(bb, hh, ww, g, 9)
    return off, mask


def deform_conv2d_raw_plain(x, res_y, res_x, mask_logits, flow_y, flow_x,
                            weight, bias, mrm: float):
    """Plain version of the fused raw-prep DCN kernel: same arguments as
    ``ops.dcn.deform_conv2d_raw``; returns (B, H, W, Cout) in x.dtype."""
    off, mask = materialize_raw(res_y, res_x, mask_logits, flow_y, flow_x,
                                mrm)
    return modulated_deform_conv2d(x, off, mask, weight, bias, padding=1)
