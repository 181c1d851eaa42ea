"""Wrapper of the hand-written Hopper DCN kernel (``csrc/dcn_raw.cu``).

``deform_conv2d_raw`` is the port's counterpart of
``flair_tpu/ops/dcn_pallas.py::deform_conv2d_tile_raw_ad``: modulated DCNv2
with the raw offset prep fused in (``off = mrm·tanh(res) + flow_half``,
``m = sigmoid(logits)``), exact bilinear sampling.

- Inputs are checked alike on every device, so the CPU runs catch a
  layout the kernel would refuse. A tensor on the CPU then goes to the
  plain version (``ops/deform.py``).
- A CUDA tensor launches the kernel or raises; nothing falls back.
- ``deform_conv2d_raw.launches`` counts kernel launches (a plain int that
  callers reset to 0 and read).
- It is a ``torch.autograd.Function``, the counterpart of the JAX
  ``custom_vjp`` (``_tile_raw_ad_bwd``): the forward is the kernel (or the
  plain version on the CPU), the backward recomputes the plain raw prep
  and exact DCN (``materialize_raw`` + ``modulated_deform_conv2d``) and
  takes their VJP for all eight tensor inputs. Only the forward launches
  the kernel. The backward runs in float32 whatever the inputs' dtype and
  casts each gradient to its input's dtype: the x gradient sums up to 9·G
  bilinear contributions a pixel through ``index_add``, and a bf16 sum of
  them would lose digits the JAX backward keeps.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .deform import deform_conv2d_raw_plain

KERNEL = "dcn_raw"
SUPPORTED_COUT = (32, 64, 128)
_CK = 32  # input channels per kernel K step (csrc/dcn_raw.cu)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dcn_raw_forward": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                         ctypes.c_float, _P], _I),
    "dcn_error_string": ([_I], ctypes.c_char_p),
}


def _check(x, res_y, res_x, mask_logits, flow_y, flow_x, weight, bias):
    """Raise on anything the kernel does not take. Returns (G, A, raw_stride)."""
    tensors = [x, res_y, res_x, mask_logits, flow_y, flow_x, weight]
    if bias is not None:
        tensors.append(bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("deform_conv2d_raw: all tensors must share a device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"deform_conv2d_raw: x dtype {x.dtype} unsupported")
    if any(t.dtype != x.dtype for t in (res_y, res_x, mask_logits)):
        raise TypeError("deform_conv2d_raw: raw blocks must have x's dtype")
    if flow_y.dtype != torch.float32 or flow_x.dtype != torch.float32:
        raise TypeError("deform_conv2d_raw: flows must be float32")
    if x.dim() != 4:
        raise ValueError("deform_conv2d_raw: x must be (B, H, W, Cin)")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} != ({cout},{cin},3,3)")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError("bias must be (Cout,)")
    gk = res_y.shape[-1]
    g = gk // 9
    a = flow_y.shape[-1]
    for t in (res_y, res_x, mask_logits):
        if tuple(t.shape) != (b, h, w, gk):
            raise ValueError("raw blocks must share the shape (B, H, W, G*9)")
    for t in (flow_y, flow_x):
        if tuple(t.shape) != (b, h, w, a) or not t.is_contiguous():
            raise ValueError("flows must be contiguous (B, H, W, A)")
    vec = 16 // x.element_size()
    if (gk % 9 or g == 0 or g % a or cin % g or cin % _CK
            or (cin // g) % vec or cout not in SUPPORTED_COUT):
        raise ValueError(
            f"deform_conv2d_raw: unsupported config Cin={cin} Cout={cout} "
            f"G={g} A={a} (need Cin % {_CK} == 0, (Cin/G) % {vec} == 0, "
            f"Cout in {SUPPORTED_COUT})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC and 16-byte aligned")
    s = res_y.stride()
    if any(t.stride() != s for t in (res_x, mask_logits)):
        raise ValueError("raw blocks must share their strides")
    if s[3] != 1 or s[2] < gk or s[1] != w * s[2] or (b > 1 and s[0] != h * s[1]):
        raise ValueError("raw blocks must be pixel-strided NHWC views")
    return g, a, s[2]


def _launch(x, res_y, res_x, mask_logits, flow_y, flow_x, weight, bias,
            mrm: float, g: int, a: int, raw_stride: int):
    """One launch of the kernel on checked CUDA tensors."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    # (Cout, Cin, 3, 3) -> (9, Cin, Cout) in x.dtype: one cast-and-copy launch
    wk = torch.empty((9, cin, cout), dtype=x.dtype, device=x.device)
    wk.copy_(weight.permute(2, 3, 1, 0).reshape(9, cin, cout))
    b32 = (torch.zeros(cout, device=x.device) if bias is None
           else bias.float().contiguous())
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = build.load(KERNEL, _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dcn_raw_forward(
            int(x.dtype == torch.bfloat16), x.data_ptr(), res_y.data_ptr(),
            res_x.data_ptr(), mask_logits.data_ptr(), flow_y.data_ptr(),
            flow_x.data_ptr(), wk.data_ptr(), b32.data_ptr(), out.data_ptr(),
            b * h * w, h, w, cin, cout, g, a, raw_stride, float(mrm), stream)
    if rc != 0:
        msg = ("unsupported Cout" if rc < 0
               else lib.dcn_error_string(rc).decode())
        raise RuntimeError(f"dcn_raw kernel launch failed ({rc}): {msg}")
    deform_conv2d_raw.launches += 1
    return out


class _DeformConvRaw(torch.autograd.Function):
    """The kernel (or the plain version on the CPU) forward; the plain
    version's float32 VJP backward."""

    @staticmethod
    def forward(ctx, x, res_y, res_x, mask_logits, flow_y, flow_x, weight,
                bias, mrm):
        g, a, raw_stride = _check(x, res_y, res_x, mask_logits, flow_y,
                                  flow_x, weight, bias)
        # the raw blocks stay the views they came as: saved, not copied
        ctx.save_for_backward(x, res_y, res_x, mask_logits, flow_y, flow_x,
                              weight, bias)
        ctx.mrm = mrm
        if x.device.type == "cpu":
            return deform_conv2d_raw_plain(x, res_y, res_x, mask_logits,
                                           flow_y, flow_x, weight, bias, mrm)
        if x.device.type != "cuda":
            raise ValueError(f"deform_conv2d_raw: no kernel for {x.device}")
        return _launch(x, res_y, res_x, mask_logits, flow_y, flow_x, weight,
                       bias, mrm, g, a, raw_stride)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        with torch.enable_grad():
            leaves = [None if t is None else
                      t.detach().float().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = deform_conv2d_raw_plain(*leaves, ctx.mrm)
            wrt = [v for v, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad_out.float()))
        return (*(next(grads).to(t.dtype) if n else None
                  for t, n in zip(saved, need)), None)


def deform_conv2d_raw(x, res_y, res_x, mask_logits, flow_y, flow_x, weight,
                      bias, mrm: float):
    """Flow-anchored modulated DCN with fused raw prep, differentiable in
    every tensor argument.

    x (B, H, W, Cin) = cat(prop_n1, prop_n2), NHWC contiguous; res_y, res_x,
    mask_logits (B, H, W, G·9) pre-activation blocks in (group, tap) order,
    x's dtype (views of one NHWC tensor are fine: they share a pixel
    stride); flow_y, flow_x (B, H, W, A) float32 per-anchor flow planes;
    weight (Cout, Cin, 3, 3); bias (Cout,) or None; mrm the max residue
    magnitude. Returns (B, H, W, Cout) in x.dtype."""
    return _DeformConvRaw.apply(x, res_y, res_x, mask_logits, flow_y, flow_x,
                                weight, bias, float(mrm))


deform_conv2d_raw.launches = 0
