"""Modulated deformable convolution (DCNv2), plain PyTorch.

The plain twin of the CUDA kernel ``csrc/dcn_raw.cu`` (wrapper:
``ops/dcn.py``): the CPU runs and the tests use it, and ``chip_smoke.py``
holds the kernel against it on the card. Counterpart of
``flair_tpu/ops/deform.py`` (``deform_conv2d``, ``modulated_deform_conv2d``)
and of ``flair_tpu/ops/dcn_pallas.py::_materialize_raw``.

Semantics are exact: every bilinear corner outside the image contributes
zero, tested per corner (the CUDA-kernel boundary rule of the reference).
The int8 twin (``deform_conv2d_raw_plain(..., int8_dots=True)``) keeps
the exact sampling and follows the int8 instance of
``flair_tpu/ops/dcn_pallas.py::_dcn_tile_kernel``: x quantised once a
call (``quantize_values``), integer corner weights, bf16 taps.

Convention: NHWC activations. ``offset`` is (B, Ho, Wo, G, K, 2) in (dy, dx)
order, ``mask`` (B, Ho, Wo, G, K), ``weight`` (Cout, Cin, kh, kw) — the torch
(OIHW) layout the port keeps its parameters in.
"""

from __future__ import annotations

import torch


def _corners(x, offset, mask, kh, kw, stride, padding, dilation):
    """The four bilinear corners of every sample, in the order (y0, x0),
    (y0, x1), (y1, x0), (y1, x1): yields (values, weight), the corner's
    values (B, Ho, Wo, G, K, Cin/G) in x's dtype and its float32 weight
    (B, Ho, Wo, G, K) with the mask folded in, zero where the corner lies
    outside the image (each corner tested on its own)."""
    b, h, w, cin = x.shape
    g = offset.shape[3]
    ho, wo = offset.shape[1], offset.shape[2]
    kk = kh * kw
    cg = cin // g
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
    for yy, xx, wy, wx in ((y0, x0, wy0, wx0), (y0, x0 + 1, wy0, wx1),
                           (y0 + 1, x0, wy1, wx0), (y0 + 1, x0 + 1, wy1, wx1)):
        iy = yy.clamp(0, h - 1).long()
        ix = xx.clamp(0, w - 1).long()
        rows = (row0 + (iy * w + ix) * g).reshape(-1)
        yield (xrows.index_select(0, rows).reshape(b, ho, wo, g, kk, cg),
               wy * wx)


def _tap_matrix(weight, g, dt):
    """(Cout, Cin, kh, kw) → (G·K·Cin/G, Cout) in ``dt``: the weight permuted
    to the samples' (group, tap, channel-in-group) order, so the samples are
    not permuted."""
    cout, cin, kh, kw = weight.shape
    return (weight.to(dt).reshape(cout, g, cin // g, kh * kw)
            .permute(1, 3, 2, 0).reshape(cin * kh * kw, cout))


def deform_conv2d(x, offset, weight, bias=None, *, mask=None, stride=1,
                  padding=1, dilation=1):
    """(Modulated) deformable conv2d, all taps at once.

    x (B, H, W, Cin); offset (B, Ho, Wo, G, K, 2); weight (Cout, Cin, kh, kw);
    mask optional (B, Ho, Wo, G, K), already sigmoided. Returns
    (B, Ho, Wo, Cout) in x.dtype. Sample coordinates stay float32 whatever
    the value dtype (bf16 cannot resolve pixel positions past 256).
    """
    b, _, _, cin = x.shape
    cout, _, kh, kw = weight.shape
    ho, wo = offset.shape[1], offset.shape[2]
    dt = x.dtype
    val = None
    for v, wt in _corners(x, offset, mask, kh, kw, stride, padding, dilation):
        t = v * wt.to(dt)[..., None]
        val = t if val is None else val + t
    # contract over (group, tap, channel-in-group): channel c = g·cg + j
    out = (val.reshape(b, ho * wo, cin * kh * kw)
           @ _tap_matrix(weight, offset.shape[3], dt)).reshape(b, ho, wo, cout)
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


INT8_LEVELS = 127.0   # symmetric int8 range of values and window weights


def quantize_values(x):
    """Symmetric int8 quantisation of x against its global max, as the JAX
    int8 instance does it (``dcn_pallas.py:386-396``): ``sx = max(max|x|,
    1e-20)``, ``xq = clip(round(x · (127 / sx)), -127, 127)`` with the f32
    scalar ``127 / sx`` formed first, rounding half to even. Returns
    (xq int8, sx f32 scalar tensor); zeros stay exactly zero."""
    lo, hi = torch.aminmax(x)   # max|x| is exact in x's own dtype
    sx = torch.clamp(torch.maximum(-lo, hi).float(), min=1e-20)
    scale = INT8_LEVELS / sx
    q = x * scale if x.dtype == torch.float32 else x.float().mul_(scale)
    # JAX's clip to ±127 changes nothing: |x| · fl(127 / sx) is at most
    # 127 · (1 + 2⁻²³), which rounds to 127
    return q.round_().to(torch.int8), sx


def dequant_scale(sx):
    """The int8 instance's dequantisation factor, value scale times window
    scale: ``sx / 127²`` in f32."""
    return sx / (INT8_LEVELS * INT8_LEVELS)


def deform_conv2d_int8(xq, dq, offset, mask, weight, bias, out_dtype):
    """The int8 instance's DCN (3×3, padding 1, stride 1) on quantised
    values ``xq`` (B, H, W, Cin) int8 with dequantisation factor ``dq``.

    - Corner weights are integers, folded in the JAX kernel's order:
      ``w2 = round(((relu(1-|dy|) · m) · relu(1-|dx|)) · 127)``, with the
      mask ``m`` rounded to bf16 as the JAX kernel's modulation block is.
    - A sample is ``Σ_{≤4 corners} w2 · xq``: at most 4·127² = 64 516, so
      the f32 sum of these integers is exact (JAX sums in int32). Then
      ``· dq`` in f32 and one rounding to bf16.
    - The taps contract against the bf16-rounded weight in f32 (products
      of bf16 values are exact in f32), the bias is added in f32, and the
      output is rounded to bf16 once and returned in ``out_dtype``.
    Corners outside the image weigh zero, as in ``deform_conv2d``."""
    b, h, w, cin = xq.shape
    f32, bf16 = torch.float32, torch.bfloat16
    acc = None
    for v, wt in _corners(xq, offset, mask.to(bf16), 3, 3, 1, 1, 1):
        t = v.to(f32) * torch.round(wt * INT8_LEVELS)[..., None]
        acc = t if acc is None else acc + t
    val = (acc * dq.to(f32)).to(bf16).to(f32)
    out = (val.reshape(b, h * w, cin * 9)
           @ _tap_matrix(weight.to(bf16), offset.shape[3], f32))
    out = out.reshape(b, h, w, -1)
    if bias is not None:
        out = out + bias.to(f32)
    return out.to(bf16).to(out_dtype)


def deform_conv2d_raw_plain(x, res_y, res_x, mask_logits, flow_y, flow_x,
                            weight, bias, mrm: float, int8_dots: bool = False):
    """Plain version of the fused raw-prep DCN kernel: same arguments as
    ``ops.dcn.deform_conv2d_raw``; returns (B, H, W, Cout) in x.dtype.
    ``int8_dots`` selects the int8 instance's numbers
    (``deform_conv2d_int8`` on ``quantize_values(x)``)."""
    off, mask = materialize_raw(res_y, res_x, mask_logits, flow_y, flow_x,
                                mrm)
    if int8_dots:
        xq, sx = quantize_values(x)
        return deform_conv2d_int8(xq, dequant_scale(sx), off, mask, weight,
                                  bias, x.dtype)
    return modulated_deform_conv2d(x, off, mask, weight, bias, padding=1)
