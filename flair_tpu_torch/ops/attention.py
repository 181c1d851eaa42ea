"""Attention: the flash-attention kernel's wrapper, its plain twin, and
windowed temporal attention.

Counterpart of ``flair_tpu/ops/attention.py``:
- ``flash_attention`` wraps the hand-written Hopper kernel
  ``csrc/flash_attn.cu``, the port of the Pallas ``_flash_kernel``. A CPU
  tensor goes to ``dot_product_attention``, its plain twin; a CUDA tensor
  launches the kernel or raises, at every sequence length (the JAX package
  took the einsum path where S did not tile by 256, a TPU tiling limit).
  ``flash_attention.launches`` counts kernel launches (a plain int that
  callers reset to 0 and read).
- Temporal window attention never materialises the reference's 7x
  ``unfold``: Q/K/V are projected per frame, the per-window-position key
  embedding is added in projected space, and each centre frame attends to
  its F-1 neighbours through clamped frame indices (replicate padding).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import build

KERNEL = "flash_attn"
SUPPORTED_HEAD_DIMS = (32, 64)


def dot_product_attention(q, k, v, scale: float | None = None):
    """Attention over (B, S, H, D) tensors; softmax in float32."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attn_forward": ([_I, _P, _P, _P, _P, _I, _I, _I, _I,
                            ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_float, _P], _I),
    "flash_error_string": ([_I], ctypes.c_char_p),
}


def _check(q, k, v):
    """Raise on anything the kernel does not take (CUDA tensors only: on the
    CPU the twin takes any head dim)."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: dtype {q.dtype} unsupported")
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("flash_attention: B*H must be at most 65535")
    vec = 16 // q.element_size()
    if any(st % vec for st in q.stride()[:3]):
        raise ValueError("flash_attention: strides must be multiples of "
                         f"{vec} elements (16-byte rows)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")


def flash_attention(q, k, v, scale: float | None = None):
    """softmax(q·kᵀ·scale)·v over (B, S, H, D) tensors (flash-attn layout),
    scale 1/√D by default, float32 softmax and accumulation; output
    (B, S, H, D) contiguous in q's dtype.

    q, k, v may be strided views of one packed tensor (the per-head
    interleave ``qkv.reshape(N, S, heads, 3, D)[..., i, :]``): they must
    share shape, dtype, device and strides, with a unit stride on D."""
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError("flash_attention: q, k, v must share one "
                         "(B, S, H, D) shape")
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must share dtype and device")
    if not (q.stride() == k.stride() == v.stride() and q.stride(3) == 1):
        raise ValueError("flash_attention: q, k, v must share strides with "
                         "a unit stride on the head dim")
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v)
    b, s, h, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = build.load(KERNEL, _SIGNATURES)
    sb, ss, sh, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_forward(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, s, h, d, sb, ss, sh,
            float(scale), stream)
    if rc != 0:
        msg = ("unsupported head dim" if rc < 0
               else lib.flash_error_string(rc).decode())
        raise RuntimeError(f"flash_attn kernel launch failed ({rc}): {msg}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
