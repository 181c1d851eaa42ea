"""DAVSRNet: deep-unfolding space-time super-resolution.

Counterpart of ``flair_tpu/models/davsr.py`` (reference davsr.py:712-1921):
an FFT-domain data-consistency prox over the 3-D (T, H, W) volume
(``data_prox_3d``; DataNet3D, davsr.py:1688-1720) alternates with one
BasicVSR++ image-space regularizer shared by every iteration
(``ImageVSRPP``), after a SuperSloMo temporal initialiser and an
align-corners spatial upsample; ``HyPaNet`` gives the prox weights. The
fixed ×4 blur kernel (davsr.py:25 ``ker_x4``) is read from the port's own
``assets/blur_kernels.npz``.

- The PSF → OTF helpers run on the host in float64 numpy, then the OTFs go
  to the device as complex64; the prox's FFTs are ``torch.fft`` (the JAX
  package runs ``jnp.fft`` through XLA, not Pallas).
- Every alignment of the regularizer calls ``ops.dcn.deform_conv2d_raw``
  (K1): the CUDA kernel on the card, float32 with ``deform_groups`` 8 at
  the defaults, 2 branches × (T·sf0 − 1) frames a regularizer call.

Videos are (B, T, H, W, C) as in the JAX package; inside the networks,
NCHW channels_last.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv2d, Dense, channels_last, nchw, nhwc
from .registry import register_model
from .spynet import SPyNet
from .superslomo import SSUNet, mean_tensor, slomo_blend
from .vsrpp import BasicVSRPP, ResidualBlocksWithInputConv

_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "assets", "blur_kernels.npz")


def load_ker_x4() -> np.ndarray:
    with np.load(_ASSET) as f:
        return np.asarray(f["ker_x4"], np.float64)


def ps2ot(psf: np.ndarray, shape) -> np.ndarray:
    """3-D PSF → OTF on the host (davsr.py:1582-1608): zero-pad to the full
    volume, roll each axis by −size/2, FFT. psf (t, h, w); shape (T, H, W).
    Float64 in, complex128 out."""
    otf = np.zeros(shape, np.float64)
    otf[: psf.shape[0], : psf.shape[1], : psf.shape[2]] = psf
    for axis, n in enumerate(psf.shape):
        otf = np.roll(otf, -int(n / 2), axis=axis)
    return np.fft.fftn(otf)


@functools.lru_cache(maxsize=4)
def _otfs(sf: tuple, shape: tuple):
    """(FB, FBC, F2B) complex64 numpy for the ×4 kernel replicated over
    sf0 frames at the volume ``shape`` (davsr.py:1848-1856)."""
    psf = np.repeat(load_ker_x4()[None], sf[0], axis=0) / sf[0]
    fb = ps2ot(psf, shape)
    return (fb.astype(np.complex64), np.conj(fb).astype(np.complex64),
            (np.abs(fb) ** 2).astype(np.complex64))


def upsample3d(x: torch.Tensor, sf) -> torch.Tensor:
    """Zero-stuffing (T, H, W) upsample (davsr.py:1609-1621):
    (B, T, H, W, C) → (B, T·s0, H·s1, W·s2, C)."""
    b, t, h, w, c = x.shape
    z = x.new_zeros((b, t * sf[0], h * sf[1], w * sf[2], c))
    z[:, ::sf[0], ::sf[1], ::sf[2]] = x
    return z


def data_prox_3d(x, FB, FBC, F2B, FBFy, alpha, sf) -> torch.Tensor:
    """FFT data-consistency prox (DataNet3D, davsr.py:1688-1713).

    ``FB`` / ``FBC`` / ``F2B`` (T, H, W) and ``FBFy`` (B, C, T, H, W)
    complex64 tensors; x (B, T, H, W, C); alpha complex64 (1, 1, 1, 1, 1).
    The block mean splits T into (s0, T/s0): contiguous chunks."""
    xt = x.movedim(-1, 1).to(torch.complex64)                # (B, C, T, H, W)
    FR = FBFy + torch.fft.fftn(alpha * xt, dim=(2, 3, 4))
    x1 = FB * FR
    b, c, T, H, W = x1.shape
    s0, s1, s2 = sf
    FBR = x1.reshape(b, c, s0, T // s0, s1, H // s1, s2, W // s2).mean(
        dim=(2, 4, 6))
    invW = F2B.reshape(s0, T // s0, s1, H // s1, s2, W // s2).mean(
        dim=(0, 2, 4)).real
    invWBR = FBR / (invW + alpha)
    FCBinvWBR = FBC * invWBR.repeat(1, 1, s0, s1, s2)
    FX = (FR - FCBinvWBR) / alpha
    xest = torch.fft.ifftn(FX, dim=(2, 3, 4)).real
    return xest.movedim(1, -1).to(x.dtype)


class HyPaNet(nn.Module):
    """1×1-conv MLP → softplus hyper-parameters (davsr.py:1722-1744)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 16, channel: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(in_nc, channel, dtype=dtype)
        self.fc2 = Dense(channel, channel, dtype=dtype)
        self.fc3 = Dense(channel, out_nc, dtype=dtype)

    def forward(self, x):
        h = F.relu(self.fc2(F.relu(self.fc1(x))))
        return F.softplus(self.fc3(h)) + 1e-6


class ImageVSRPP(nn.Module):
    """Image-space BasicVSR++ regularizer (davsr.py:1081-1537): feature
    extraction, bidirectional second-order propagation with the DCN
    alignment, reconstruction to RGB with a global residual. x (B, T, H,
    W, C) → the same shape."""

    def __init__(self, in_ch: int = 3, mid_channels: int = 64,
                 num_blocks: int = 5, deform_groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.feat_extract = ResidualBlocksWithInputConv(
            in_ch, mid_channels, num_blocks, dtype)
        self.spynet = SPyNet()
        self.vsrpp = BasicVSRPP(mid_channels, deform_groups=deform_groups,
                                dtype=dtype)
        self.recon = ResidualBlocksWithInputConv(mid_channels, mid_channels,
                                                 1, dtype)
        self.conv_out = Conv2d(mid_channels, in_ch, 3, dtype=dtype)

    def forward(self, x):
        b, t, h, w, c = x.shape

        def frames(v):   # (B, T', H, W, C) → (B·T', C, H, W)
            return channels_last(nchw(v.reshape(-1, h, w, c)))

        feat = self.feat_extract(frames(x))
        lq01 = torch.clamp(x, 0, 1)
        l1, l2 = frames(lq01[:, :-1]), frames(lq01[:, 1:])
        fwd = self.spynet(l2, l1).reshape(b, t - 1, 2, h, w)
        bwd = self.spynet(l1, l2).reshape(b, t - 1, 2, h, w)
        feat = self.vsrpp(feat, b, fwd, bwd)
        out = self.conv_out(self.recon(feat))
        return x + nhwc(out).reshape(b, t, h, w, c)


def _up_mat(o: int, i: int) -> np.ndarray:
    """(o, i) bilinear align_corners=True resample matrix, float32."""
    m = np.zeros((o, i), np.float32)
    for k in range(o):
        p = k * (i - 1) / (o - 1) if o > 1 else 0.0
        p0 = int(np.floor(p))
        f = p - p0
        m[k, p0] += 1 - f
        m[k, min(p0 + 1, i - 1)] += f
    return m


@register_model("davsr")
class DAVSRNet(nn.Module):
    """Deep-unfolding space-time SR (davsr.py:1746-1921). ``forward(x)``
    with x (B, T, H, W, 3) in [0, 1] returns (B, T·sf0, H·sf1, W·sf2, 3)."""

    def __init__(self, n_iter: int = 4, h_nc: int = 64,
                 mid_channels: int = 64, num_blocks: int = 5,
                 sf: Sequence[int] = (5, 4, 4), deform_groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.n_iter = n_iter
        self.sf = tuple(sf)
        self.flow = SSUNet(6, 4, dtype)
        self.interp = SSUNet(20, 5, dtype)
        self.hypanet = HyPaNet(3, n_iter * 2, h_nc)
        # ONE regularizer shared by the unfolding iterations
        # (davsr.py:1763-1772, reused in the loop at :1914-1916)
        self.vsr = ImageVSRPP(3, mid_channels, num_blocks, deform_groups,
                              dtype)

    def forward(self, x, *, return_after_first_prox: bool = False):
        """``return_after_first_prox``: stop after the first data prox,
        before the regularizer (the longest prefix that admits
        converted-weight parity with the reference, whose own forward
        breaks at the second iteration; flair_tpu/models/davsr.py)."""
        b, t, h, w, c = x.shape
        s0, s1, s2 = self.sf
        T, H, W = t * s0, h * s1, w * s2
        dev = x.device
        # copies: the cached host arrays stay unshared
        FB, FBC, F2B = (torch.tensor(a, device=dev)
                        for a in _otfs(self.sf, (T, H, W)))
        STy = upsample3d(x, self.sf)
        FBFy = FBC * torch.fft.fftn(STy.movedim(-1, 1).to(torch.complex64),
                                    dim=(2, 3, 4))

        # temporal initialiser: SuperSloMo UNets (davsr.py:1788-1833)
        mean = mean_tensor(x)
        x0 = x - mean
        f0 = channels_last(nchw(x0[:, :-1].reshape(-1, h, w, c)))
        f1 = channels_last(nchw(x0[:, 1:].reshape(-1, h, w, c)))
        flow_out = self.flow(torch.cat([f0, f1], dim=1))
        f01, f10 = flow_out[:, :2], flow_out[:, 2:]
        inters = [nhwc(slomo_blend(self.interp, f0, f1, f01, f10, i / s0))
                  + mean for i in range(1, s0)]
        x_inter = torch.stack(inters, dim=1).reshape(b, t - 1, s0 - 1, h, w,
                                                     c)

        # the T·s0-frame init: replicate pads at both ends around the
        # per-gap interpolations (davsr.py:1874-1890, s0 − 1 pads in all)
        pre_pad = (s0 - 1) // 2
        post_pad = (s0 - 1) - pre_pad
        pieces = [x[:, :1].expand(b, pre_pad, h, w, c)]
        for i in range(t - 1):
            pieces += [x[:, i:i + 1], x_inter[:, i]]
        pieces += [x[:, t - 1:], x[:, -1:].expand(b, post_pad, h, w, c)]
        xt = torch.cat(pieces, dim=1)

        # bilinear align_corners=True spatial upsample (davsr.py:1891-1897)
        ry = torch.from_numpy(_up_mat(H, h)).to(device=dev, dtype=xt.dtype)
        rx = torch.from_numpy(_up_mat(W, w)).to(device=dev, dtype=xt.dtype)
        xt = torch.einsum("uh,bthwc->btuwc", ry, xt)
        xt = torch.einsum("vw,bthwc->bthvc", rx, xt)

        ab = self.hypanet(torch.tensor([[0.0, float(s0), float(s1)]],
                                       device=dev))      # (1, 2·n_iter)

        def alpha(i):
            return ab[0, i].to(torch.complex64).reshape(1, 1, 1, 1, 1)

        if return_after_first_prox:
            return data_prox_3d(xt, FB, FBC, F2B, FBFy, alpha(0), self.sf)
        for i in range(self.n_iter):
            xt = data_prox_3d(xt, FB, FBC, F2B, FBFy, alpha(i), self.sf)
            xt = self.vsr(xt)
        return xt
