"""BasicVSR++ second-order propagation with flow-guided deformable alignment.

Counterpart of ``flair_tpu/models/vsrpp.py`` (reference unet.py:313-661).
The JAX package runs each propagation branch as a ``lax.scan``; here it is
a Python loop over frames (``_run_branch``), keeping the JAX package's
hoist: the frame-independent halves of ``offset_conv0`` (feat_current and
flows) and of the backbone input conv (feat_current and extra) run once
for all frames, and only the halves that read the propagated carry stay in
the loop. At the first frame of a branch the alignment is skipped and the
aligned feature is zero (the reference multiplies it by zero).

Every alignment calls ``ops.dcn.deform_conv2d_raw``: the CUDA kernel on the
card, its plain twin on the CPU. ``FLAIR_DCN_INT8=1`` selects its int8
instance, as the JAX package's ``_tile_config`` reads the variable. The
glue around the convs of a step (the warp of both hidden states, each
bias and activation, the gated residual) is ``ops.vsrpp_step``: one kernel
launch each on the card (under autograd too, with a plain float32
backward), the plain op sequence on the CPU. The forward copies nothing
from the host.

Conventions: hidden features (B·T, C, H, W) channels_last; flows
(B, T-1, 2, H, W) float32, channel 0 = dx; gating weights in the host layout
(B, T, H, W, 1) or (B, T, 1, 1, 1).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcn import deform_conv2d_raw
from ..ops.vsrpp_step import bias_act, gate_tail, warp_pair
from ..ops.warp import flow_warp
from ..parallel.collectives import all_gather_frames
from ..utils.spans import span
from .common import Conv2d, _lecun_, channels_last, leaky_relu, nchw, nhwc
from .registry import register_model


def compose_second_order_flows(flows_forward, flows_backward):
    """Window-constant second-order flows of both branches
    (unet.py:466-476: ``flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1)``),
    one batched warp per branch. Inputs (B, T-1, 2, H, W); returns
    (fwd2, bwd2), each (B, T, 2, H, W) frame-indexed, zero where the branch
    has fewer than two predecessors."""
    b, tm1, _, h, w = flows_forward.shape
    t = tm1 + 1
    dt = flows_forward.dtype
    dev = flows_forward.device
    z1 = torch.zeros((b, 1, 2, h, w), dtype=dt, device=dev)
    z2 = torch.zeros((b, 2, 2, h, w), dtype=dt, device=dev)
    j = torch.arange(t, device=dev)

    def comp(n1, n2, gate):
        warped = flow_warp(n2.reshape(b * t, 2, h, w),
                           n1.reshape(b * t, 2, h, w)).reshape(b, t, 2, h, w)
        return gate.view(1, t, 1, 1, 1).to(dt) * (n1 + warped)

    bwd, fwd = flows_backward, flows_forward
    bwd2 = comp(torch.cat([bwd, z1], 1), torch.cat([bwd[:, 1:], z2], 1),
                j < t - 2)
    fwd2 = comp(torch.cat([z1, fwd], 1), torch.cat([z2, fwd[:, :-1]], 1),
                j > 1)
    return fwd2, bwd2


def resize_weight_map(weight, h: int, w: int):
    """Nearest-resize a (B, T, H0, W0, 1) gating map to (h, w): output row i
    takes input row floor(i·H0 / h), as ``resize_matrix(..., "nearest")``
    selects it, by an index built on the map's device (no host copy)."""
    def rows(out: int, inp: int):
        i = torch.arange(out, device=weight.device) * inp // out
        return i.clamp_max(inp - 1)

    return weight.index_select(2, rows(h, weight.shape[2])).index_select(
        3, rows(w, weight.shape[3]))


def _offset_perm(g: int) -> torch.Tensor:
    """Output-channel permutation of ``offset_out`` making its y / x offset
    planes contiguous: the reference interleaves (group, tap, y|x) per
    anchor half (unet.py:636-645). Weights are stored in reference order
    and permuted when applied."""
    ko = 9 * (g // 2)
    base_c = torch.arange(ko) * 2
    return torch.cat([
        base_c, 2 * ko + base_c,              # y: half 1, half 2
        base_c + 1, 2 * ko + base_c + 1,      # x: half 1, half 2
        torch.arange(4 * ko, 27 * g),         # mask block unchanged
    ])


def apply_deform_align(x, raw_y, raw_x, mask_logits, flow_y, flow_x, weight,
                       bias, *, max_residue_magnitude: float):
    """Deformable alignment from PRE-ACTIVATION offset/mask blocks.

    ``x`` (B, 2C, H, W) = cat(prop_n1, prop_n2) with NHWC storage (the
    step's pair); ``raw_y``/``raw_x``/``mask_logits`` (B, H, W, G·9) NHWC
    views in (group, tap) order (the first G/2 groups anchored on flow 1),
    in x's dtype; ``flow_y``/``flow_x`` (B, H, W, 2) float32 planes of both
    anchors' flows, contiguous; ``weight`` (C, 2C, 3, 3). Offsets, masks
    and sample coordinates stay float32; values run in x's dtype.

    ``FLAIR_DCN_INT8=1`` in the environment (read at every call, default
    off) runs the DCN's int8 instance, as JAX's ``_tile_config``
    (``flair_tpu/models/vsrpp.py:81``) passes ``int8_dots`` to every K1
    call. JAX takes its exact patch path off the TPU and never runs int8
    there; the port runs its kernel's numbers on every device."""
    int8 = os.environ.get("FLAIR_DCN_INT8", "0") == "1"
    y = deform_conv2d_raw(nhwc(x), raw_y, raw_x, mask_logits, flow_y, flow_x,
                          weight, bias, float(max_residue_magnitude),
                          int8_dots=int8)
    return nchw(y)


class ResidualBlockNoBN(nn.Module):
    """mmedit ResidualBlockNoBN: x + conv2(relu(conv1(x)))."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualBlocksWithInputConv(nn.Module):
    """Input conv + LeakyReLU(0.1) + num_blocks residual blocks (mmedit)."""

    def __init__(self, in_ch: int, features: int, num_blocks: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv_in = Conv2d(in_ch, features, 3, dtype=dtype)
        for i in range(num_blocks):
            setattr(self, f"block{i}", ResidualBlockNoBN(features, dtype))

    def forward(self, x):
        x = leaky_relu(self.conv_in(x), 0.1)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class _AlignParams(nn.Module):
    """SecondOrderDeformableAlignment's parameters (names and shapes of the
    flax tree); applied functionally by ``_run_branch``."""

    def __init__(self, features: int, deform_groups: int):
        super().__init__()
        c, g = features, deform_groups
        self.offset_conv0 = Conv2d(3 * c + 4, c, 3)
        self.offset_conv1 = Conv2d(c, c, 3)
        self.offset_conv2 = Conv2d(c, c, 3)
        self.offset_out = Conv2d(c, 27 * g, 3, zero_init=True)
        self.weight = nn.Parameter(torch.zeros(c, 2 * c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))
        _lecun_(self.weight.data, 2 * c * 9)
        # a constant of the layout, not a weight: kept out of state_dict
        self.register_buffer("offset_perm", _offset_perm(g), persistent=False)


class _BranchParams(nn.Module):
    """One propagation branch: deform_align + backbone."""

    def __init__(self, features: int, conv_in_ch: int, deform_groups: int):
        super().__init__()
        self.deform_align = _AlignParams(features, deform_groups)
        self.backbone = ResidualBlocksWithInputConv(conv_in_ch, features, 1)


def _run_branch(p: _BranchParams, feats, extra, flow1, flow2, weight, order,
                b: int, *, deform_groups: int, max_residue_magnitude: float,
                dtype):
    """One propagation branch (unet.py:440-492) as a loop over ``order``.

    ``feats`` (B·T, C, H, W) current features and ``extra`` (the backward
    branch's output, forward branch only) in natural frame order;
    ``flow1``/``flow2`` (B, T, 2, H, W) the branch's first- and second-order
    flow AT each frame; ``weight`` (B, T, h, w, 1) gating. Returns the
    per-frame outputs (B·T, C, H, W) in natural frame order.

    The hidden pair [prop_n1 | prop_n2] is one (B, 2C, H, W) tensor with
    NHWC storage, the layout K1 reads; the glue around each conv is one
    ``ops.vsrpp_step`` call (a kernel launch on the card)."""
    n, c, h, w = feats.shape
    t = n // b
    g = deform_groups
    dt = dtype
    al, bb = p.deform_align, p.backbone

    def conv(v, k):
        return F.conv2d(v.to(dt), k, padding=k.shape[-1] // 2)

    def prep(k):  # a conv weight in the compute dtype and cuDNN's layout
        return k.to(dt).contiguous(memory_format=torch.channels_last)

    k0 = al.offset_conv0.weight
    k0_xs = prep(torch.cat([k0[:, c:2 * c], k0[:, 3 * c:]], dim=1))
    k0_ser = prep(torch.cat([k0[:, :c], k0[:, 2 * c:3 * c]], dim=1))
    k1, k2 = prep(al.offset_conv1.weight), prep(al.offset_conv2.weight)
    ko_p = prep(al.offset_out.weight.index_select(0, al.offset_perm))
    bo_p = al.offset_out.bias.index_select(0, al.offset_perm)
    kin = bb.conv_in.weight
    e = 0 if extra is None else extra.shape[1]
    kin_xs, kin_ser = prep(kin[:, :c + e]), prep(kin[:, c + e:])
    kb1, kb2 = prep(bb.block0.conv1.weight), prep(bb.block0.conv2.weight)

    # ---- hoisted frame-batched halves ---------------------------------
    # offset_conv0 input blocks: [0:C) cond_n1, [C:2C) feat_current,
    # [2C:3C) cond_n2, [3C:3C+4) flows (f1x, f1y, f2x, f2y)
    fl = channels_last(torch.cat([flow1, flow2], dim=2).reshape(n, 4, h, w))
    h0_xs = bias_act(conv(torch.cat([feats.to(dt), fl.to(dt)], dim=1), k0_xs),
                     al.offset_conv0.bias)
    # backbone conv_in blocks: [0:C) feat_current, [C:C+e) extra, then prop
    bb_in = feats if e == 0 else torch.cat([feats, extra], dim=1)
    bb_xs = bias_act(conv(bb_in, kin_xs), bb.conv_in.bias)
    # K1's flow planes of both anchors, every frame: (T, B, H, W, 2)
    flow_y, flow_x = (torch.stack([flow1[:, :, i], flow2[:, :, i]], dim=-1)
                      .transpose(0, 1).float().contiguous() for i in (1, 0))

    def frame(v, j):  # (B·T, ...) → frame j of every clip
        return v.reshape(b, t, *v.shape[1:])[:, j]

    out = torch.empty_like(feats)
    pair = channels_last(torch.zeros((b, 2 * c, h, w), dtype=feats.dtype,
                                     device=feats.device))
    koff = 9 * (g // 2)
    for i, j in enumerate(order):
        if i > 0:
            hh = bias_act(conv(warp_pair(pair, flow1[:, j], flow2[:, j]),
                               k0_ser), addend=frame(h0_xs, j), act="leaky")
            hh = bias_act(conv(hh, k1), al.offset_conv1.bias, act="leaky")
            hh = bias_act(conv(hh, k2), al.offset_conv2.bias, act="leaky")
            # the raw blocks are channel slices of one NHWC tensor
            o = nhwc(bias_act(conv(hh, ko_p), bo_p))
            prop = apply_deform_align(
                pair, o[..., :2 * koff], o[..., 2 * koff:4 * koff],
                o[..., 4 * koff:], flow_y[j], flow_x[j], al.weight, al.bias,
                max_residue_magnitude=max_residue_magnitude)
            r = bias_act(conv(prop, kin_ser), addend=frame(bb_xs, j),
                         act="leaky")
        else:  # no aligned feature at a branch's first frame
            prop = None
            r = bias_act(frame(bb_xs, j), act="leaky")
        y = conv(bias_act(conv(r, kb1), bb.block0.conv1.bias, act="relu"),
                 kb2)
        pair = gate_tail(prop, r, y, bb.block0.conv2.bias, weight[:, j],
                         frame(out, j), pair)
    return out


@register_model("basicvsrpp")
class BasicVSRPP(nn.Module):
    """Bidirectional second-order propagation (unet.py:313-595).

    ``forward(hidden, b, flows_forward, flows_backward, weight=None,
    flows_forward2=None, flows_backward2=None)``; hidden (B·T, C, H, W);
    returns hidden + zero-init conv(reconstruction(cat(hidden, bwd, fwd))).

    Under ``frame_group`` hidden and weight hold this rank's frames and the
    flows the whole clip's: the recurrence is sequential over frames, so the
    hidden state and the weights are all-gathered, both branches run over
    the whole clip on every rank (K1's launches a rank are the unsharded
    call's), and the reconstruction runs on the rank's frames."""

    def __init__(self, features: int, max_residue_magnitude: float = 10.0,
                 deform_groups: int = 16, dtype=torch.float32):
        super().__init__()
        c = features
        self.max_residue_magnitude = max_residue_magnitude
        self.deform_groups = deform_groups
        self.dtype = dtype
        self.frame_group = None
        self.backward_1 = _BranchParams(c, 2 * c, deform_groups)
        self.forward_1 = _BranchParams(c, 3 * c, deform_groups)
        self.reconstruction = ResidualBlocksWithInputConv(3 * c, c, 1, dtype)
        self.conv_last = Conv2d(c, c, 1, zero_init=True, dtype=dtype)

    def forward(self, hidden, b: int, flows_forward, flows_backward,
                weight=None, flows_forward2=None, flows_backward2=None):
        with span("vsrpp"):
            group, local = self.frame_group, hidden
            if group is not None:
                hidden = _gather_nchw(hidden, b, group)
                if weight is not None:
                    weight = all_gather_frames(weight, group, 1)
            n, c, h, w = hidden.shape
            t = n // b
            if weight is None:
                weight = torch.ones((b, t, 1, 1, 1), dtype=hidden.dtype,
                                    device=hidden.device)
            else:
                if weight.dim() == 5 and weight.shape[2] not in (1, h):
                    weight = resize_weight_map(weight, h, w)
                # the gating multiply runs in the trunk dtype (unet.py:489)
                weight = weight.to(hidden.dtype)
            if flows_forward2 is None or flows_backward2 is None:
                flows_forward2, flows_backward2 = compose_second_order_flows(
                    flows_forward, flows_backward)
            zeros = torch.zeros((b, 1, 2, h, w), dtype=flows_forward.dtype,
                                device=hidden.device)
            cfg = dict(deform_groups=self.deform_groups,
                       max_residue_magnitude=self.max_residue_magnitude,
                       dtype=self.dtype)
            # backward branch: frames T-1 → 0; first-order flow at frame j is
            # flows_backward[:, j] (none at the last frame)
            bwd = _run_branch(self.backward_1, hidden, None,
                              torch.cat([flows_backward, zeros], 1),
                              flows_backward2, weight, range(t - 1, -1, -1), b,
                              **cfg)
            # forward branch: frames 0 → T-1; flow at frame j is
            # flows_forward[:, j-1] (none at frame 0)
            fwd = _run_branch(self.forward_1, hidden, bwd,
                              torch.cat([zeros, flows_forward], 1),
                              flows_forward2, weight, range(t), b, **cfg)
            if group is not None:
                tl = local.shape[0] // b
                lo = dist.get_rank(group) * tl

                def mine(v):
                    v = v.reshape(b, t, c, h, w)[:, lo:lo + tl]
                    return channels_last(v.reshape(b * tl, c, h, w))

                hidden, bwd, fwd = local, mine(bwd), mine(fwd)
            hr = self.reconstruction(torch.cat([hidden, bwd, fwd], dim=1))
            return hidden + self.conv_last(hr)


def _gather_nchw(x, b: int, group):
    """Every rank's frames of (B·T_local, C, H, W) → (B·T, C, H, W)
    channels_last, gathered in the NHWC layout (a view for channels_last
    input)."""
    n, c, h, w = x.shape
    v = all_gather_frames(nhwc(x).reshape(b, n // b, h, w, c), group, 1)
    return nchw(v.reshape(-1, h, w, c))
