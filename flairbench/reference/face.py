"""FLAIR's face fusion around the face networks, plain float32: the
gray-border bicubic crop of each frame onto the face template, the parse →
paste-mask colormap, two 101-tap σ 26 Gaussian blurs and the zeroed 10-px
border, the inverse paste of the clamped face, and the weights w_t of the
face window (facelib/utils/face_restoration_helper.py:203-335 and
guided_diffusion/gaussian_diffusion.py:471-494, 632-646 of
wustl-cig/FLAIR).

Warps follow cv2.warpAffine with INTER_CUBIC, written from its
definition: Keys' cubic (a = −0.75) over the 4 × 4 taps around each
output pixel's source point, taps outside the image reading the border
value, and an output pixel whose source point lies outside the half-pixel
box −0.5 ≤ s ≤ size − 0.5 taking the border value. Images are
(N, H, W, C) in [-1, 1].

The networks' own outputs (the restored faces, the parse logits) are the
program's, recorded in its window: this file works out everything around
them again.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GRAY_BORDER = (135.0 / 255 * 2 - 1, 133.0 / 255 * 2 - 1, 132.0 / 255 * 2 - 1)
# parse classes 1-13 are the face; 0 and 14-18 (background, hair, ears,
# neck, cloth) are not (face_restoration_helper.py:281-302)
MASK_COLORMAP = (0.0,) + (1.0,) * 13 + (0.0,) * 5
BLUR_TAPS, BLUR_SIGMA, MASK_BORDER = 101, 26.0, 10
# of each task with a face prior (video_sample.py:35-171): the demo's
# fusion weight, its face window in steps of a 100-step schedule, and the
# VSR++ weight of the parsed background
TASKS = {"x8_bicubic": (0.85, 5, 0.93)}


def window(task: str, n: int):
    """(ws, tau) of an n-step schedule: the fusion weight w_t of each step
    and the lowest step of the face window τ ≤ t ≤ n − 1, the demo's τ
    kept as a fraction of the schedule."""
    w, tau100, _ = TASKS[task]
    tau = tau100 if n == 100 else max(1, round(tau100 * n / 100))
    start = n - 1
    ws = np.ones(n)
    if start - tau > 0:
        v = np.exp(-np.linspace(0, 1, start - tau + 1))
        ws[tau:] = 1 - (v - v.min()) / (v.max() - v.min()) * (1 - w)
    else:
        ws[:] = w
    return ws, tau


def keys(d: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys' cubic convolution weight at distance d."""
    d = d.abs()
    near = ((a + 2) * d - (a + 3)) * d * d + 1
    far = ((a * d - 5 * a) * d + 8 * a) * d - 4 * a
    return torch.where(d <= 1, near, torch.where(d < 2, far,
                                                 torch.zeros_like(d)))


def warp(img: torch.Tensor, src_of: torch.Tensor, out_hw, border):
    """(N, Ho, Wo, C): each output pixel (x, y) samples ``img`` at
    ``src_of`` · (x, y, 1); ``src_of`` (N, 2, 3); ``border`` a number or
    (C,) values. Coordinates and weights are float32; values stay in
    ``img``'s dtype."""
    n, h, w, c = img.shape
    ho, wo = out_hw
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(ho, dtype=torch.float32, device=dev),
                            torch.arange(wo, dtype=torch.float32, device=dev),
                            indexing="ij")
    a = src_of.float()[:, :, :, None, None]
    sx = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]
    sy = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = sx - x0, sy - y0
    border = torch.as_tensor(border, dtype=img.dtype, device=dev)
    flat = img.reshape(n, h * w, c)
    out = torch.zeros((n, ho, wo, c), dtype=img.dtype, device=dev)
    for j in range(-1, 3):
        yy, wy = y0 + j, keys(fy - j)
        for i in range(-1, 3):
            xx, wx = x0 + i, keys(fx - i)
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(flat, 1, idx.reshape(n, -1, 1).expand(-1, -1, c))
            v = torch.where(inside[..., None], v.reshape(n, ho, wo, c), border)
            out = out + (wy * wx)[..., None].to(img.dtype) * v
    box = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    return torch.where(box[..., None], out, border)


def inverse(m: torch.Tensor) -> torch.Tensor:
    """(N, 2, 3) affine maps inverted, in float64."""
    full = torch.zeros((m.shape[0], 3, 3), dtype=torch.float64,
                       device=m.device)
    full[:, :2] = m.double()
    full[:, 2, 2] = 1
    return torch.linalg.inv(full)[:, :2]


def crop(frames: torch.Tensor, mats: torch.Tensor, size: int):
    """Each frame's face on the template (``mats`` map frame → face), a
    gray border around the frame; clamped to [-1, 1] as it enters the
    restoration network."""
    return warp(frames, inverse(mats), (size, size), GRAY_BORDER).clamp(-1, 1)


def blur(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(101, σ 26) of (N, H, W, 1), reflect-101 edges."""
    k = np.arange(BLUR_TAPS) - (BLUR_TAPS - 1) / 2
    k = np.exp(-k ** 2 / (2 * BLUR_SIGMA ** 2))
    k = torch.as_tensor(k / k.sum(), dtype=x.dtype, device=x.device)
    p = BLUR_TAPS // 2
    v = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    v = F.conv2d(F.conv2d(v, k.view(1, 1, -1, 1)), k.view(1, 1, 1, -1))
    return v.permute(0, 2, 3, 1)


def paste_mask(restored, logits=None) -> torch.Tensor:
    """(N, S, S, 1): the colormap of each pixel's most likely class (all
    ones without a parser), blurred twice, its outer 10 px zeroed."""
    if logits is None:
        m = torch.ones_like(restored[..., :1])
    else:
        cmap = torch.as_tensor(MASK_COLORMAP, dtype=restored.dtype,
                               device=restored.device)
        m = cmap[logits.argmax(-1)][..., None]
    m = blur(blur(m))
    e = MASK_BORDER
    return F.pad(m[:, e:-e, e:-e], (0, 0, e, e, e, e))


def fuse(frames, restored, mask, mats):
    """The frames with each restored face pasted back through the inverse
    of its crop: the face clamped to [-1, 1] before and after its warp,
    blended by the warped mask (zero outside the face)."""
    h, w = frames.shape[1:3]
    m = mats.double()
    face = warp(restored.clamp(-1, 1), m, (h, w), 0.0).clamp(-1, 1)
    inv_mask = warp(mask, m, (h, w), 0.0)
    return frames * (1 - inv_mask) + face * inv_mask


def codeformer(net, faces, codes=None):
    """A CodeFormer-like network on NHWC faces, applied as the demo does
    (w = 1, AdaIN: video_sample.py:450-452): (restored faces, code
    logits). ``codes`` (N, L), where given, replace the network's own
    argmax."""
    out, logits, _ = net(faces.permute(0, 3, 1, 2), w=1.0, adain=True,
                         codes=codes)
    return out.permute(0, 2, 3, 1), logits


def parse(net, faces):
    """A ParseNet-like network's (N, S, S, classes) logits of NHWC faces."""
    return net(faces.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)


# each face network's application, by its name in a configuration
APPLY = {"codeformer": codeformer, "parsenet": parse}
