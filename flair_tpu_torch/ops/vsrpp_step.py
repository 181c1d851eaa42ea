"""BasicVSR++'s per-frame glue: the elementwise work around each conv of a
propagation step (``models/vsrpp.py::_run_branch``) as one pass each.

- ``warp_pair``: both hidden states of the pair [n1 | n2] warped by their
  flows (``flow_warp``'s bilinear sampling), as one (B, 2C, H, W) tensor.
- ``bias_act``: ``act(x + bias + addend)`` after a conv; ``act`` None,
  "leaky" (LeakyReLU 0.1) or "relu".
- ``gate_tail``: the step's end, ``(prop + (r + (y + bias))) * gate``,
  stored into the output's frame slot and returned as the next pair
  [v | n1].

Each has a plain version, the op sequence the step ran before
(``*_plain``), and a hand-written CUDA kernel (``csrc/vsrpp_step.cu``) that
computes in float32 and rounds once on store. A CUDA tensor takes the
kernel, or an error; every other device the plain version. Where autograd
records the call (training) the kernel runs inside an
``autograd.Function`` whose backward is the plain version's float32 VJP,
as ``ops/norms._GroupNormAct``'s. The kernel route checks its inputs and
raises on what the kernel does not take: activations of one dtype (bf16
or float32), C % 8 == 0, NHWC storage (channels_last, or channel slices
of it) 16-byte aligned. ``bias_act`` takes any C: a width that is not
whole 8-channel vectors (the offset head's 27·G when 8 does not divide G)
runs its scalar instance, which needs only unit-stride channels. Each
op's ``launches`` counts its kernel launches (a plain int that callers
reset to 0 and read), one a call.

Tensors are the models' (N, C, H, W) views with NHWC storage; gates are in
the host layout, (B, h, w, 1) or (B, 1, 1, 1).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import build
from .warp import flow_warp

KERNEL = "vsrpp_step"
_VEC = 8    # channels a kernel thread: one 16-byte vector of bf16
_ACTS = {None: 0, "leaky": 1, "relu": 2}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_V = [_P, _L, _I]   # an NHWC view: pointer, frame stride, pixel stride
_SIGNATURES = {
    "vsrpp_warp_pair_launch": ([_I, *_V, _P, _P, _L, *_V, _I, _I, _I, _I,
                                _P], _I),
    "vsrpp_bias_act_launch": ([_I, _I, *_V, _P, *_V, *_V, _I, _I, _I, _I,
                               _P], _I),
    "vsrpp_gate_tail_launch": ([_I, *_V, *_V, *_V, _P, _P, _L, _L, _L, *_V,
                                *_V, *_V, _I, _I, _I, _I, _P], _I),
    "vsrpp_step_error_string": ([_I], ctypes.c_char_p),
}


def _nhwc_empty(like: torch.Tensor):
    """An uninitialised tensor of ``like``'s shape with NHWC storage, and
    its kernel view (pointer, frame stride, pixel stride)."""
    t = torch.empty_like(like, memory_format=torch.channels_last)
    return t, (t.data_ptr(), t.stride(0), t.stride(3))


# ------------------------------------------------------------- plain ----

def warp_pair_plain(pair, flow_1, flow_2):
    n1, n2 = pair.chunk(2, dim=1)
    both = flow_warp(torch.cat([n1, n2], dim=0),
                     (torch.cat([flow_1[:, 0], flow_2[:, 0]], dim=0),
                      torch.cat([flow_1[:, 1], flow_2[:, 1]], dim=0)))
    both = both.contiguous(memory_format=torch.channels_last)
    return torch.cat(both.chunk(2, dim=0), dim=1)


def bias_act_plain(x, bias=None, addend=None, act=None):
    if bias is not None:
        x = x + bias.to(x.dtype)[None, :, None, None]
    if addend is not None:
        x = x + addend
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    return F.relu(x) if act == "relu" else x


def gate_tail_plain(prop, r, y, bias, gate, out, pair):
    rb = y + bias.to(y.dtype)[None, :, None, None]
    s = r + rb if prop is None else prop + (r + rb)
    v = (s * gate.permute(0, 3, 1, 2).to(pair.dtype)).to(pair.dtype)
    out.copy_(v)
    return torch.cat([v, pair[:, :pair.shape[1] // 2]], dim=1)


# ------------------------------------------------------ kernel inputs ----

def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _records(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: the kernel then runs
    inside its ``autograd.Function`` (a no-grad call skips the Function's
    cost, about 1 500 calls a denoiser step)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _view(t: torch.Tensor, c: int, dtype, device, what: str,
          vec: int = _VEC):
    """(pointer, frame stride, pixel stride) of an (N, c, H, W) view whose
    channels are unit-stride and whose pixels lie at one stride, row after
    row, with its ``vec``-channel vectors 16-byte aligned when ``vec`` is
    8; raises on anything else."""
    if t.dtype != dtype or t.device != device:
        raise TypeError(f"vsrpp_step: {what} is {t.dtype} on {t.device}, "
                        f"needs {dtype} on {device}")
    if t.dim() != 4 or t.shape[1] != c:
        raise ValueError(f"vsrpp_step: {what} {tuple(t.shape)} has not "
                         f"{c} channels")
    sb, sc, sh, sw = t.stride()
    h, w = t.shape[2], t.shape[3]
    aligned = vec == 1 or not (sw % vec or sb % vec or t.data_ptr() % 16)
    if sc != 1 or sw < c or (h > 1 and sh != w * sw) or not aligned:
        raise ValueError(f"vsrpp_step: {what} needs NHWC storage with "
                         f"{vec}-channel vectors aligned, got strides "
                         f"{t.stride()}")
    return t.data_ptr(), sb, sw


def _check_width(c: int, what: str, vec: int = _VEC) -> None:
    if c % vec:
        raise ValueError(f"vsrpp_step: {what} takes {vec} | C, got C = {c}")


def _float_vec(v: torch.Tensor, c: int, device, what: str) -> int:
    if v.dtype != torch.float32 or v.shape != (c,) or v.device != device \
            or v.stride(0) != 1:
        raise TypeError(f"vsrpp_step: {what} must be a float32 ({c},) "
                        f"vector on {device}")
    return v.data_ptr()


def _flow(f: torch.Tensor, like: torch.Tensor) -> tuple:
    b, _, h, w = like.shape
    if (f.dtype != torch.float32 or f.device != like.device
            or tuple(f.shape) != (b, 2, h, w) or f.stride(3) != 1
            or f.stride(2) != w or f.stride(1) != h * w):
        raise ValueError(f"vsrpp_step: a flow must be float32 ({b}, 2, {h}, "
                         f"{w}) with dense planes, got {f.dtype} "
                         f"{tuple(f.shape)} strides {f.stride()}")
    return f.data_ptr(), f.stride(0)


def _launch(fn: str, device, *args) -> None:
    """``fn`` of the library with ``args`` and the current stream of
    ``device``; raises on a refused launch."""
    lib = build.load(KERNEL, _SIGNATURES)
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args,
                              torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = ("unsupported shape" if rc < 0
               else lib.vsrpp_step_error_string(rc).decode())
        raise RuntimeError(f"{fn} failed ({rc}): {msg}")


def _is_bf16(t: torch.Tensor) -> int:
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"vsrpp_step: dtype {t.dtype} unsupported")
    return int(t.dtype == torch.bfloat16)


# ------------------------------------------------------------ kernels ----

def _warp_pair_kernel(pair, flow_1, flow_2):
    b, c2, h, w = pair.shape
    _check_width(c2, "warp_pair (both halves)", 2 * _VEC)
    bf16 = _is_bf16(pair)
    src = _view(pair, c2, pair.dtype, pair.device, "pair")
    (p1, fbs), (p2, fbs2) = _flow(flow_1, pair), _flow(flow_2, pair)
    if fbs != fbs2:
        raise ValueError("vsrpp_step: the two flows need one frame stride")
    out, dst = _nhwc_empty(pair)
    _launch("vsrpp_warp_pair_launch", pair.device, bf16, *src, p1, p2, fbs,
            *dst, b, h, w, c2 // 2)
    warp_pair.launches += 1
    return out


def _bias_act_kernel(x, bias, addend, act):
    b, c, h, w = x.shape
    vec = _VEC if c % _VEC == 0 else 1
    bf16 = _is_bf16(x)
    src = _view(x, c, x.dtype, x.device, "x", vec)
    pb = None if bias is None else _float_vec(bias, c, x.device, "bias")
    add = ((None, 0, c) if addend is None
           else _view(addend, c, x.dtype, x.device, "addend", vec))
    if addend is not None and addend.shape != x.shape:
        raise ValueError(f"bias_act: addend {tuple(addend.shape)} is not "
                         f"{tuple(x.shape)}")
    y, dst = _nhwc_empty(x)
    _launch("vsrpp_bias_act_launch", x.device, bf16, _ACTS[act], *src, pb,
            *add, *dst, b, h * w, c, vec)
    bias_act.launches += 1
    return y


def _gate_tail_kernel(prop, r, y, bias, gate, out, pair):
    b, c, h, w = r.shape
    _check_width(c, "gate_tail")
    if (any(t is not None and t.shape != r.shape for t in (prop, y, out))
            or pair.shape != (b, 2 * c, h, w)):
        raise ValueError("gate_tail: prop, r, y and out must share one "
                         "(B, C, H, W) shape and pair be (B, 2C, H, W)")
    dt, dev = r.dtype, r.device
    bf16 = _is_bf16(r)
    pv = ((None, 0, c) if prop is None
          else _view(prop, c, dt, dev, "prop"))
    if gate.dtype != dt or gate.device != dev or gate.dim() != 4 or \
            gate.shape[0] != b or gate.shape[3] != 1:
        raise ValueError(f"gate_tail: gate {gate.dtype} "
                         f"{tuple(gate.shape)} is not ({b}, h, w, 1) {dt}")
    if tuple(gate.shape[1:3]) == (1, 1):
        gsy = gsx = 0
    elif tuple(gate.shape[1:3]) == (h, w):
        gsy, gsx = gate.stride(1), gate.stride(2)
    else:
        raise ValueError(f"gate_tail: gate {tuple(gate.shape)} is neither "
                         f"per frame nor ({b}, {h}, {w}, 1)")
    npair, dst = _nhwc_empty(pair)
    _launch("vsrpp_gate_tail_launch", dev, bf16, *pv,
            *_view(r, c, dt, dev, "r"), *_view(y, c, dt, dev, "y"),
            _float_vec(bias, c, dev, "bias"), gate.data_ptr(), gate.stride(0),
            gsy, gsx, *_view(pair, 2 * c, dt, dev, "pair"),
            *_view(out, c, dt, dev, "out"), *dst, b, h, w, c)
    gate_tail.launches += 1
    return npair


# ------------------------------------------------------- under autograd ----
# Each backward is its plain version's VJP in float32, each gradient in its
# input's dtype. The warp replays its plain version; the others are written
# out so that they save nothing the step does not hold anyway: the bias's
# activation reads the sign of its output (the next conv's input), and the
# tail's inputs are saved only when the gate needs a gradient.

class _WarpPair(torch.autograd.Function):
    """The warp kernel forward; ``warp_pair_plain`` replayed in float32."""

    @staticmethod
    def forward(ctx, pair, flow_1, flow_2):
        ctx.save_for_backward(pair, flow_1, flow_2)
        return _warp_pair_kernel(pair, flow_1, flow_2)

    @staticmethod
    def backward(ctx, grad):
        saved, need = ctx.saved_tensors, ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(n)
                      for t, n in zip(saved, need)]
            got = iter(torch.autograd.grad(
                warp_pair_plain(*leaves), [v for v, n in zip(leaves, need)
                                           if n], grad.float()))
        return tuple(next(got).to(t.dtype) if n else None
                     for t, n in zip(saved, need))


class _BiasAct(torch.autograd.Function):
    """The bias-activation kernel forward; the activation's derivative from
    the sign of the output, which is the pre-activation's (slope 0.1 > 0)."""

    @staticmethod
    def forward(ctx, x, bias, addend, act):
        y = _bias_act_kernel(x, bias, addend, act)
        ctx.act = act
        ctx.save_for_backward(y if act else None)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        y, = ctx.saved_tensors
        if ctx.act == "leaky":
            g = torch.where(y > 0, g, g * 0.1)
        elif ctx.act == "relu":
            g = torch.where(y > 0, g, 0.0)
        nx, nb, na, _ = ctx.needs_input_grad
        return (g.to(grad.dtype) if nx else None,
                g.sum((0, 2, 3)) if nb else None,
                g.to(grad.dtype) if na else None, None)


class _GateTail(torch.autograd.Function):
    """The tail kernel forward, which also fills ``out`` (recorded by
    ``_Filled``); the VJP of the next pair [v | pair[:, :C]]."""

    @staticmethod
    def forward(ctx, prop, r, y, bias, gate, pair, out):
        npair = _gate_tail_kernel(prop, r, y, bias, gate, out, pair)
        ctx.dtype = r.dtype
        ctx.save_for_backward(gate, *((prop, r, y, bias)
                                      if ctx.needs_input_grad[4] else ()))
        return npair

    @staticmethod
    def backward(ctx, grad):
        gate, *terms = ctx.saved_tensors
        need = ctx.needs_input_grad
        c = grad.shape[1] // 2
        gv = grad[:, :c].float()
        gs = gv * gate.permute(0, 3, 1, 2).float()     # the gradient of s
        gg = None
        if need[4]:
            prop, r, y, bias = terms
            sv = r.float() + (y.float() + bias[None, :, None, None])
            sv = sv if prop is None else prop.float() + sv
            dims = [1] if gate.shape[1] > 1 else [1, 2, 3]
            gg = (gv * sv).sum(dims, keepdim=True).permute(0, 2, 3, 1)
        gp = None
        if need[5]:
            gp = torch.zeros_like(grad)
            gp[:, :c] = grad[:, c:]
        dt = ctx.dtype
        return (gs.to(dt) if need[0] else None, gs.to(dt) if need[1] else None,
                gs.to(dt) if need[2] else None,
                gs.sum((0, 2, 3)) if need[3] else None,
                gg.to(gate.dtype) if need[4] else None, gp, None)


class _Filled(torch.autograd.Function):
    """Records that ``out`` now holds ``v`` (the tail kernel wrote it):
    autograd refuses a Function that writes a view in place and returns
    more than one tensor, so the write and its record are two Functions.
    The old contents of ``out`` get a zero gradient, not None: on a view,
    None would drop the gradient of the rest of its base."""

    @staticmethod
    def forward(ctx, out, v):
        ctx.mark_dirty(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad), grad


# ------------------------------------------------------------ the ops ----

def warp_pair(pair, flow_1, flow_2):
    """``pair`` (B, 2C, H, W) = [n1 | n2]; ``flow_1`` / ``flow_2`` (B, 2, H,
    W) float32 pixel displacements (channel 0 = dx). Returns (B, 2C, H, W)
    [flow_warp(n1, flow_1) | flow_warp(n2, flow_2)] with NHWC storage:
    bilinear, zero padding, align_corners=True, float32 coordinates."""
    if not _on_card(pair):
        return warp_pair_plain(pair, flow_1, flow_2)
    if _records(pair, flow_1, flow_2):
        return _WarpPair.apply(pair, flow_1, flow_2)
    return _warp_pair_kernel(pair, flow_1, flow_2)


def bias_act(x, bias=None, addend=None, act=None):
    """``act(x + bias + addend)`` over (B, C, H, W): ``bias`` a (C,)
    parameter or None, ``addend`` a tensor of x's shape or None, ``act``
    None, "leaky" (slope 0.1) or "relu". The kernel returns a new tensor
    with NHWC storage; 8-channel vectors where 8 divides C, else a channel
    a thread."""
    if act not in _ACTS:
        raise ValueError(f"bias_act: activation {act!r} unsupported")
    if not _on_card(x):
        return bias_act_plain(x, bias, addend, act)
    if _records(x, bias, addend):
        return _BiasAct.apply(x, bias, addend, act)
    return _bias_act_kernel(x, bias, addend, act)


def gate_tail(prop, r, y, bias, gate, out, pair):
    """The end of a step: ``v = (prop + (r + (y + bias))) * gate`` over (B,
    C, H, W) (``prop`` None at a branch's first frame, which has no aligned
    feature; ``bias`` the (C,) parameter of the conv that made ``y``;
    ``gate`` (B, H, W, 1) or (B, 1, 1, 1)), written into ``out``, the
    output's (B, C, H, W) frame slot. Returns the next step's pair
    [v | pair[:, :C]], (B, 2C, H, W) with NHWC storage."""
    if not _on_card(r):
        return gate_tail_plain(prop, r, y, bias, gate, out, pair)
    if not _records(prop, r, y, bias, gate, pair):
        return _gate_tail_kernel(prop, r, y, bias, gate, out, pair)
    npair = _GateTail.apply(prop, r, y, bias, gate, pair, out)
    _Filled.apply(out, npair[:, :r.shape[1]])
    return npair


warp_pair.launches = 0
bias_act.launches = 0
gate_tail.launches = 0
