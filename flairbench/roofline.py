"""The yardstick's arithmetic: the card's peaks, each hand-written
kernel's least time from its shapes, the device-time classes of kernel
names, and the FLOPs of one denoiser call counted on the frozen reference.

The peaks and bound functions are copies of ``chip_smoke.py``'s
(``PEAK_BF16``, ``MEM_BW``, ``dcn_bound_ms``, ``flash_bound_ms``,
``KERNEL_CLASSES``), kept here so that the program cannot move them.
"""

from __future__ import annotations

import importlib

import torch
from torch.utils.flop_counter import FlopCounterMode

MEM_BW = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12       # float32 outside the tensor cores

KERNEL_CLASSES = (   # first match wins, on the lower-cased kernel name
    ("dcn_raw (K1)", ("dcn_raw",)),
    ("flash_attn (K2)", ("flash_fwd",)),
    ("grid_sample", ("sampler",)),
    ("pad / layout", ("pad", "nchwtonhwc", "nhwctonchw")),
    ("convolution", ("fprop", "conv", "dgrad")),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("softmax", ("softmax",)),
    ("reduction / norm", ("reduce", "norm", "welford", "moments")),
    ("cat / copy", ("cat", "copy")),
    ("gather", ("indexselect", "index_select", "gather")),
    ("fft", ("fft",)),
    ("elementwise", ("elementwise",)),
)
GLUE = ("elementwise", "cat / copy", "pad / layout")


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def dcn_bound_ms(h, cin, cout, x_bytes, g=16, peak=PEAK_BF16):
    """K1 at (1, h², cin) → cout with g deform groups: x, the three raw
    blocks, both anchors' flow planes and the output in the kernel's dtype
    (``x_bytes``), W and bias in float32, each read or written once;
    2·h²·9·cin·cout FLOP at ``peak``. Returns (ms, what binds)."""
    px = h * h
    gk = g * 9
    nbytes = (px * cin * x_bytes + 3 * px * gk * x_bytes + 2 * px * 2 * 4
              + px * cout * x_bytes + 9 * cin * cout * 4 + cout * 4)
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = 2.0 * px * 9 * cin * cout / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def flash_bound_ms(bh, s, d, elt_bytes):
    """K2: q, k, v read once and o written once; 4·BH·S²·D FLOP for the
    two products, at the bf16 tensor-core rate (2-byte elements) or the
    float32 CUDA-core rate. Returns (ms, what binds)."""
    t_bytes = 4 * bh * s * d * elt_bytes / MEM_BW * 1e3
    peak = PEAK_BF16 if elt_bytes == 2 else PEAK_F32
    t_ops = 4.0 * bh * s * s * d / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def reference_class(entry: dict):
    """The frozen reference class that ``entry`` (a configuration, or a
    face network of its ``face`` object) names as ``<module>.<class>`` of
    ``flairbench.reference``."""
    module, cls = entry["reference"].split(".")
    return getattr(importlib.import_module(
        f"flairbench.reference.{module}"), cls)


def count_face(config: dict, frames: int):
    """On ``meta``: the FLOPs of the reference face networks that the
    configuration names (none named: 0), as (a denoiser call's mean share
    of the face steps' CodeFormer and ParseNet on ``frames`` crops, a
    window's ParseNet of its init frames)."""
    from .inputs import FACE_NETS
    from .reference import face
    spec, s = config["face"], config["output_size"]
    n = int(config["steps"][len("ddim"):])
    _, tau = face.window(config["task"], n)
    faces = torch.empty(frames, s, s, 3)
    flops = {}
    for name in FACE_NETS:
        entry = spec.get(name)
        if entry is None or not entry.get("reference"):
            continue
        net = reference_class(entry)(**entry["kwargs"])
        with FlopCounterMode(display=False) as fc:
            face.APPLY[name](net, faces)
        flops[name] = fc.get_total_flops()
    step = flops.get("codeformer", 0) + flops.get("parsenet", 0)
    return step * (n - tau) / n, flops.get("parsenet", 0)


def count_call(config: dict, traffic: dict) -> dict:
    """On the ``meta`` device, at the cell's shapes: the FLOPs of one
    window's flows (SPyNet, once a window) and of one denoiser call given
    them, counted by ``FlopCounterMode`` over the frozen reference, so the
    count is the same whatever implements a layer (with the face prior on,
    plus ``count_face``'s); and the least time of
    one call's K1 and K2 launches (the reference's DCN and spatial
    attention sites, at the program's dtype)."""
    from .reference.nn import AttentionBlock
    from .reference.vsrpp import Align
    cls = reference_class(config)
    with torch.device("meta"):
        ref = cls(**config["model_kwargs"])
        b, t, s = traffic["clips"], traffic["window"], config["output_size"]
        x = torch.empty(b, t, s, s, 3)
        cond = torch.empty(b, t)
        with FlopCounterMode(display=False) as fc:
            flows = ref.flows(x)
        window = fc.get_total_flops()
        dcn, attn = [], []
        for m in ref.modules():
            if isinstance(m, Align):
                m.record = dcn
            if isinstance(m, AttentionBlock):
                m.record = attn
        with FlopCounterMode(display=False) as fc:
            ref(x, cond, x, flows)
        call = fc.get_total_flops()
        if config.get("face_prior"):
            face_step, face_window = count_face(config, b * t)
            call += face_step
            window += face_window
    elt = torch.tensor([], dtype=getattr(torch, config["dtype"])).element_size()
    return {"flops_window": float(window), "flops_call": float(call),
            "k1_bound_ms": sum(dcn_bound_ms(h, cin, cout, elt, g)[0]
                               for h, cin, cout, g in dcn),
            "k2_bound_ms": sum(flash_bound_ms(bh, sq, d, elt)[0]
                               for bh, sq, d in attn),
            "k1_sites": len(dcn), "k2_sites": len(attn)}
