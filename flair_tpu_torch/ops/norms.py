"""Normalisation primitives with float32 statistics.

Counterpart of ``flair_tpu/ops/norms.py`` (reference GroupNorm32,
nn.py:652-654, and ShiftWindowGroupNorm32, nn.py:657-748). Both take
channels-last views (B, ..., C) — for the port's NCHW channels_last
activations that is ``x.permute(0, 2, 3, 1)`` reshaped to (B, T, H, W, C),
a free view — and return the input dtype with statistics, weight and bias
applied in float32. Under a frame group (``group_norm(group=)``, frame-
sharded clips) the statistics are joint over every rank's frames.

``group_norm_act`` is the GroupNorm the models call: ``group_norm`` with
the elementwise work around it (a per-(frame, channel) pre-add, ADM's
scale-shift, SiLU). Its plain version composes those operations in the
models' order; on a CUDA tensor outside a frame group it launches the
hand-written kernel ``csrc/group_norm.cu`` (two passes over x and three
launches in place of about ten passes) or raises, and under autograd its
backward is the plain version's float32 VJP. ``group_norm_act.launches``
counts kernel launches, three a call (a plain int that callers reset to 0
and read).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_mean
from ..utils import build

KERNEL = "group_norm"


def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               eps: float = 1e-5, group=None, out_dtype=None) -> torch.Tensor:
    """GroupNorm over (B, ..., C): statistics per batch element over every
    remaining dim × (C/G) — for a (B, T, H, W, C) video JOINT over frames,
    the reference's LazyReshaper3D(GroupNorm32) convention. ``group``: the
    frames are sharded over this process group, and the statistics are
    joint over all of them (norms.py:43-47). The result is in
    ``out_dtype``, x's dtype by default."""
    orig_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    shape = xf.shape
    b, c = shape[0], shape[-1]
    xg = xf.reshape(b, -1, num_groups, c // num_groups)
    if group is None:
        var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    else:
        # ranks hold equal frame counts, so the mean of the local moments is
        # the global moment; one all-reduce carries both
        moments = torch.stack([xg.mean(dim=(1, 3), keepdim=True),
                               (xg * xg).mean(dim=(1, 3), keepdim=True)])
        mean, m2 = all_reduce_mean(moments, group).unbind(0)
        var = m2 - mean * mean
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(shape)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(orig_dtype)


def _per_frame(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B·T, C) tensor as (B, T, 1, ..., 1, C), broadcasting over x."""
    return a.reshape(*x.shape[:2], *([1] * (x.dim() - 3)), x.shape[-1])


def group_norm_act_plain(x, num_groups, weight=None, bias=None, *,
                         pre_add=None, scale=None, shift=None, act=None,
                         out_dtype=None, eps: float = 1e-5, group=None):
    """``group_norm_act`` as the models composed it: the pre-add in x's
    dtype, ``group_norm``, ``* (1 + scale) + shift``, then the activation,
    each rounding to its dtype."""
    if pre_add is not None:
        x = x + _per_frame(pre_add, x).to(x.dtype)
    y = group_norm(x, num_groups, weight, bias, eps, group, out_dtype)
    if scale is not None:
        y = y * (1 + _per_frame(scale, y))
    if shift is not None:
        y = y + _per_frame(shift, y)
    return F.silu(y) if act == "silu" else y


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "group_norm_rows": ([_I], _I),
    "group_norm_forward": ([_I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _L, _I, _P, _L, _I, _P, _L,
                            _I, ctypes.c_float, _P], _I),
    "group_norm_error_string": ([_I], ctypes.c_char_p),
}
_DTYPES = (torch.bfloat16, torch.float32)
# (x, y) dtypes the kernel takes: the trunk's bf16, the final norms' bf16
# in and float32 out, and float32 models
_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32))
_MAX_C = 2048    # a block holds one 8-channel vector of every channel


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(n: int, hw: int, rows: int, sms: int):
    """(K, chunk, KA): the statistics kernel's chunks a frame and pixels a
    chunk, and the apply kernel's blocks a frame, for blocks ``rows`` pixels
    deep. About four blocks an SM in all, and at least 16 pixel rows a
    thread in the statistics."""
    per_frame = max(1, math.ceil(4 * sms / n))
    k = max(1, min(per_frame, math.ceil(hw / (16 * rows))))
    chunk = math.ceil(hw / k)
    return math.ceil(hw / chunk), chunk, max(1, min(per_frame,
                                                    math.ceil(hw / rows)))


def _check(x, num_groups, out_dtype):
    """Raises on a call the kernel does not take."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if (x.dtype, out_dtype) not in _PAIRS:
        raise TypeError(f"group_norm_act: {x.dtype} -> {out_dtype} "
                        "unsupported")
    if x.dim() < 3:
        raise ValueError("group_norm_act: x must be (B, T, ..., C)")
    c = x.shape[-1]
    if c % 8 or c > _MAX_C:
        raise ValueError(f"group_norm_act: the kernel takes C % 8 == 0 and "
                         f"C <= {_MAX_C}, got C = {c}")
    if c % num_groups:
        raise ValueError(f"group_norm_act: {c} channels in {num_groups} "
                         "groups")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_act: x must be contiguous channels-last "
                         "and 16-byte aligned")
    if x.numel() // (x.shape[0] * x.shape[1] * c) >= 2 ** 31 or \
            x.shape[0] * x.shape[1] > 65535:
        raise ValueError(f"group_norm_act: {tuple(x.shape)} is too large")


def _aux(a, n: int, c: int, device):
    """(pointer, row stride, is bf16) of a per-(frame, channel) tensor."""
    if a is None:
        return None, 0, 0
    if a.shape != (n, c) or a.device != device:
        raise ValueError(f"group_norm_act: per-frame tensors must be ({n}, "
                         f"{c}) on {device}, got {tuple(a.shape)} on "
                         f"{a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"group_norm_act: dtype {a.dtype} unsupported")
    if a.stride(1) != 1:
        raise ValueError("group_norm_act: per-frame tensors need a unit "
                         "channel stride")
    return a.data_ptr(), a.stride(0), int(a.dtype == torch.bfloat16)


def _param(p, c: int):
    return None if p is None else p.float().contiguous().reshape(c)


def _launch(x, num_groups, weight, bias, pre_add, scale, shift, act,
            out_dtype, eps):
    """The three kernels on a CUDA x (frames on dim 1) that ``_check``
    passed."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, t, c = x.shape[0], x.shape[1], x.shape[-1]
    n = b * t
    hw = x.numel() // (n * c)
    lib = build.load(KERNEL, _SIGNATURES)
    k, chunk, ka = _grid(n, hw, lib.group_norm_rows(c),
                         _sm_count(x.device.index))
    weight, bias = _param(weight, c), _param(bias, c)
    aux = [_aux(a, n, c, x.device) for a in (pre_add, scale, shift)]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    ws = torch.empty(2 * n * (k + 1) * c, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.group_norm_forward(
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(act == "silu"), x.data_ptr(), y.data_ptr(), ws.data_ptr(),
            n, t, hw, c, num_groups, k, chunk, ka,
            None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(),
            *aux[0], *aux[1], *aux[2], float(eps), stream)
    if rc != 0:
        msg = ("unsupported shape" if rc < 0
               else lib.group_norm_error_string(rc).decode())
        raise RuntimeError(f"group_norm kernel launch failed ({rc}): {msg}")
    group_norm_act.launches += 3
    return y


class _GroupNormAct(torch.autograd.Function):
    """The kernel forward; the plain version's float32 VJP backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, pre_add, scale, shift, num_groups, act,
                out_dtype, eps):
        ctx.save_for_backward(x, weight, bias, pre_add, scale, shift)
        ctx.args = num_groups, act, eps
        return _launch(x, num_groups, weight, bias, pre_add, scale, shift,
                       act, out_dtype, eps)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        num_groups, act, eps = ctx.args
        with torch.enable_grad():
            leaves = [None if t is None else
                      t.detach().float().requires_grad_(n)
                      for t, n in zip(saved, need)]
            x, weight, bias, pre_add, scale, shift = leaves
            out = group_norm_act_plain(x, num_groups, weight, bias,
                                       pre_add=pre_add, scale=scale,
                                       shift=shift, act=act, eps=eps)
            wrt = [v for v, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad_out.float()))
        return (*(next(grads).to(t.dtype) if n else None
                  for t, n in zip(saved, need)), None, None, None, None)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def group_norm_act(x: torch.Tensor, num_groups: int, weight=None, bias=None,
                   *, pre_add=None, scale=None, shift=None, act=None,
                   out_dtype=None, eps: float = 1e-5, group=None):
    """``act(group_norm(x + pre_add) * (1 + scale) + shift)`` over a
    channels-last (B, T, ..., C) x, statistics joint over each clip's
    frames. ``pre_add``, ``scale`` and ``shift`` are per-(frame, channel)
    (B·T, C) tensors or None; ``act`` is None or "silu"; the result is in
    ``out_dtype`` (x's dtype by default).

    On a CUDA x outside a frame group this is the kernel, or an error for a
    call it does not take (``_check``: C % 8 != 0, C > 2048, a float32 x
    with a bf16 result, a strided x). It skips the plain version's
    roundings after the pre-add and between the norm, the scale-shift and
    the SiLU; under autograd its backward is the plain version's float32
    VJP. A frame group (the statistics need an all-reduce between the
    passes) and the CPU take ``group_norm_act_plain``."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm_act: activation {act!r} unsupported")
    if _on_card(x) and group is None:
        _check(x, num_groups, out_dtype)
        return _GroupNormAct.apply(x, weight, bias, pre_add, scale, shift,
                                   num_groups, act, out_dtype, eps)
    return group_norm_act_plain(x, num_groups, weight, bias, pre_add=pre_add,
                                scale=scale, shift=shift, act=act,
                                out_dtype=out_dtype, eps=eps, group=group)


group_norm_act.launches = 0


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
