"""Shared building blocks: convs, dense, norms, activations.

Counterpart of ``flair_tpu/models/common.py``. Activations are NCHW tensors
with (B·T) folded into N, in ``torch.channels_last`` memory format (physically
NHWC, so cuDNN and the DCN kernel take them without a copy). Parameters are
float32 (flax's ``param_dtype``) and are cast to the module's compute
``dtype`` at use: a bf16 trunk with float32 norm statistics, as in the JAX
package. Parameter names follow the flax scopes (see ``utils/convert.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.norms import group_norm_act, shift_window_group_norm
from ..parallel.halo import halo_exchange_frames


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, H, W, C) view (contiguous for channels_last x)."""
    return x.permute(0, 2, 3, 1)


def nchw(y: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, C, H, W) view (channels_last for contiguous y)."""
    return y.permute(0, 3, 1, 2)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _lecun_(w: torch.Tensor, fan_in: int) -> None:
    nn.init.normal_(w, std=1.0 / math.sqrt(max(fan_in, 1)))


def random_init_(module: nn.Module, seed: int = 0, scale: float = 0.02) -> None:
    """Seeded random weights: every parameter N(0, scale²), as the JAX CLI
    draws them when no checkpoint is given (cli.py:93-106)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * scale)


def checkpointed(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept (flax ``nn.remat``): a non-reentrant
    ``torch.utils.checkpoint`` while autograd records, a plain call
    otherwise (serving under ``no_grad`` is unchanged).

    The recompute must see the tensors the forward saw. Under
    ``torch.func.functional_call`` (the training wrappers) those are the
    caller's ``params``, which the module no longer holds when the backward
    runs, so the module's parameters and buffers are captured here and put
    back for the recompute by ``functional_call``."""
    if not torch.is_grad_enabled():
        return module(*args, **kwargs)
    held = dict(module.named_parameters())
    held.update(module.named_buffers())

    def run(*a, **kw):
        return torch.func.functional_call(module, held, a, kw)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


class Conv2d(nn.Module):
    """k×k conv over (N, C, H, W); padding defaults to SAME (k // 2);
    ``groups`` as in ``F.conv2d`` (flax ``feature_group_count``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int | None = None,
                 use_bias: bool = True, zero_init: bool = False,
                 groups: int = 1, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        if not zero_init:
            _lecun_(self.weight.data,
                    in_ch // groups * kernel_size * kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, groups=self.groups)


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm (flax ``use_running_average=True``, eps
    1e-5), float32 out."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class Conv3d(nn.Module):
    """(kt, 1, 1)-style 3-D conv over the frames of (B·T, C, H, W): applied
    to the (B, C, T, H, W) view, which is channels_last_3d when the input
    is channels_last — no copy. Under ``frame_group`` (frame-sharded clips)
    the local frames take a ``kt // 2``-frame halo from their neighbours,
    zero at the clip's ends as the unsharded padding is."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=(3, 1, 1),
                 zero_init: bool = False, dtype=torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.dtype = dtype
        self.frame_group = None
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        if not zero_init:
            _lecun_(self.weight.data, in_ch * math.prod(self.kernel_size))

    def forward(self, x: torch.Tensor, b: int) -> torch.Tensor:
        n, c, h, w = x.shape
        dt = self.dtype
        pad = [k // 2 for k in self.kernel_size]
        x = x.to(dt)
        if self.frame_group is not None:
            x = halo_exchange_frames(x, pad[0], self.frame_group,
                                     edge="zero", b=b)
            pad[0] = 0
        v = x.reshape(b, x.shape[0] // b, c, h, w).permute(0, 2, 1, 3, 4)
        y = F.conv3d(v, self.weight.to(dt), self.bias.to(dt),
                     padding=tuple(pad))
        return channels_last(y.permute(0, 2, 1, 3, 4).reshape(n, -1, h, w))


class Dense(nn.Module):
    """Linear over the last axis (flax ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, zero_init: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)
        if not zero_init:
            _lecun_(self.weight.data, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, JOINT over the frames of each clip:
    ``forward(x, b)`` with x (B·T, C, H, W). The group count is
    gcd(num_groups, C), as in the JAX package. Under ``frame_group`` the
    statistics are joint over every rank's frames (JAX's ``axis_name``).
    The keywords fold the callers' neighbouring operations into the norm
    (``ops.norms.group_norm_act``): ``pre_add``, ``scale`` and ``shift``
    are (B·T, C) tensors, ``act`` None or "silu"."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = math.gcd(num_groups, channels)
        self.frame_group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, b: int, *, pre_add=None, scale=None,
                shift=None, act=None, out_dtype=None) -> torch.Tensor:
        n, c, h, w = x.shape
        v = nhwc(x).reshape(b, n // b, h, w, c)
        y = group_norm_act(v, self.num_groups, self.weight, self.bias,
                           pre_add=pre_add, scale=scale, shift=shift, act=act,
                           out_dtype=out_dtype, group=self.frame_group)
        return nchw(y.reshape(n, h, w, c))


class ShiftWindowGroupNorm(nn.Module):
    """Temporally windowed group norm of (B·T, C, H, W) (nn.py:657-748).
    Not frame-shardable: under a ``frame_group`` it raises, as the JAX
    package asserts (temporal.py:62-65)."""

    def __init__(self, channels: int, win_size: int, num_groups: int = 32):
        super().__init__()
        self.win_size = win_size
        self.num_groups = num_groups
        self.frame_group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, b: int) -> torch.Tensor:
        if self.frame_group is not None:
            raise ValueError("shift_window_norm is not frame-shardable")
        n, c, h, w = x.shape
        v = nhwc(x).reshape(b, n // b, h, w, c)
        y = shift_window_group_norm(v, self.num_groups, self.win_size,
                                    self.weight, self.bias)
        return nchw(y.reshape(n, h, w, c))


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
