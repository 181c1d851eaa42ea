"""The guided DDIM step of FLAIR, plain float32 with float64 tables: the
respaced schedule, the data-consistency operators (SRConv for x8 / x16,
the FFT null-space PseudoSR ×4 for gaussian), the face prior's fusion
(``face.py``) and the η = 0 update with the overlap pinning of a window
after the first (guided_diffusion/gaussian_diffusion.py:423-517 of
wustl-cig/FLAIR).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from . import face as face_ref

HERE = os.path.dirname(os.path.abspath(__file__))

# task: (beta schedule, base steps, ζ, noise level, upscale of the init)
TASKS = {"x8_bicubic": ("face_bicubic", 2000, -1.0, 0.0, "bicubic"),
         "gaussian": ("face_blur", 1000, 1.0, 2.55, "area")}


def respaced(task: str, steps: str):
    """(alphas_cumprod, timestep_map, gammas) of the respaced schedule,
    float64: ``steps`` "ddimN" keeps range(0, T, i) for the integer stride
    i that gives N steps."""
    name, base, zeta, noise, _ = TASKS[task]
    if name == "face_bicubic":
        betas = np.linspace(1e-6, 1e-2, 2000)
    else:
        betas = np.linspace(1e-4 * 1000 / base, 0.02 * 1000 / base, base)
    n = int(steps[len("ddim"):])
    stride = next(i for i in range(1, base) if len(range(0, base, i)) == n)
    keep = list(range(0, base, stride))
    acp_all = np.cumprod(1.0 - betas)
    acp = acp_all[keep]
    gammas = np.ones(n)
    if zeta != -1:
        g = zeta * noise ** 2 / ((1 - acp) / acp)
        g[g >= 1] = 0.991
        g[g <= 0.1] = 1e-6
        gammas = 1 - g
    return acp, np.asarray(keep), gammas


def init_frames(frames01, task, size):
    """Degraded [0, 1] frames (B, T, h, w, 3) → the conditioning at
    ``size`` in [-1, 1] and SPyNet's input: bicubic for x8 (both the
    same), area for gaussian with a bicubic SPyNet input."""
    b, t, h, w, c = frames01.shape
    v = frames01.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w)

    def up(mode):
        kw = {} if mode == "area" else dict(align_corners=False)
        u = F.interpolate(v, size=(size, size), mode=mode, **kw)
        return u.reshape(b, t, c, size, size).permute(0, 1, 3, 4, 2)

    mode = TASKS[task][4]
    init = up(mode).clamp(0, 1) * 2 - 1
    rnn = init if mode == "bicubic" else (up("bicubic") * 2 - 1).clamp(-1, 1)
    return init, rnn


def bicubic_kernel(factor, a=-0.5):
    x = (np.arange(factor * 4) - np.floor(factor * 4 / 2) + 0.5) / factor
    ax = np.abs(x)
    k = np.where(ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
                 np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax
                          - 4 * a, 0.0))
    return k / k.sum()


class SRConv:
    """x8 consistency: A = M·X·Mᵀ per channel with M the 1-D bicubic
    filter + decimation matrix (reflect-padded), its singular values below
    3e-2 zeroed; the correction A⁺(A(x0) − y), A⁺ = P·Y·Pᵀ."""

    def __init__(self, size, factor, device):
        k = bicubic_kernel(factor)
        m = np.zeros((size // factor, size))
        for i in range(factor // 2, size + factor // 2, factor):
            for j in range(i - len(k) // 2, i + len(k) // 2):
                je = -j - 1 if j < 0 else (2 * size - 1 - j if j >= size
                                           else j)
                m[i // factor, je] += k[j - i + len(k) // 2]
        u, s, vt = np.linalg.svd(m, full_matrices=False)
        keep = s >= 3e-2
        st = np.where(keep, s, 0.0)
        inv = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
        self.m = torch.tensor((u * st) @ vt, dtype=torch.float32,
                              device=device)
        self.p = torch.tensor((vt.T * inv) @ u.T, dtype=torch.float32,
                              device=device)

    def correction(self, x0, y):
        """x0 (N, H, W, 3), y (N, h, w, 3)."""
        def sep(a, img):
            a = a.to(img.dtype)
            rows = torch.einsum("uh,nhwc->nuwc", a, img)
            return torch.einsum("vw,nuwc->nuvc", a, rows)
        return sep(self.p, sep(self.m, x0) - y)


def _center_mass(kernel, sf):
    """Recentre a square kernel on its centre of mass and trim it to a
    size that fits ``sf`` (imresize_pseudoSR.py:121-157)."""
    from scipy.signal import convolve2d
    n = kernel.shape[0]
    xg, yg = np.meshgrid(np.arange(n), np.arange(n))
    xg = convolve2d(xg, kernel, mode="valid") + 1
    yg = convolve2d(yg, kernel, mode="valid") + 1
    x_pad, y_pad = 2 * (n / 2 - xg), 2 * (n / 2 - yg)
    diff = np.round(np.abs(y_pad)) - np.round(np.abs(x_pad))
    pre_x, post_x = np.maximum(0, -x_pad), np.maximum(0, x_pad)
    pre_y, post_y = np.maximum(0, -y_pad), np.maximum(0, y_pad)

    def r(v):
        return int(np.round(np.asarray(v).item()))

    def split(pre, post, d):
        right = np.round(post) - post - (np.round(pre) - pre)
        pre, post = r(pre), r(post)
        big, small = int(np.ceil(d / 2)), int(np.floor(d / 2))
        return (pre + small, post + big) if right > 0 else (pre + big,
                                                            post + small)

    if diff > 0:
        pre_y, post_y = r(pre_y), r(post_y)
        pre_x, post_x = split(pre_x, post_x, diff)
    elif diff < 0:
        pre_x, post_x = r(pre_x), r(post_x)
        pre_y, post_y = split(pre_y, post_y, -diff)
    else:
        pre_x, post_x, pre_y, post_y = (r(v) for v in (pre_x, post_x, pre_y,
                                                       post_y))
    kernel = np.pad(kernel, ((pre_y, post_y), (pre_x, post_x)))
    total = np.sqrt(np.sum(kernel ** 2))
    energy = [1.0] + [np.sqrt(np.sum(kernel[i:-i, i:-i] ** 2)) / total
                      for i in range(1, int(np.ceil(kernel.shape[0] / 2)))]
    margins = np.argwhere(np.asarray(energy) < 0.99)[0][0] * np.ones(2, int)
    idx = 0
    while (kernel.shape[0] - margins.sum() - 1 + (sf + 1) % 2) % sf:
        margins[idx] -= 1
        idx = 1 - idx
    kernel = kernel[margins[0]:-margins[1], margins[0]:-margins[1]]
    return kernel / kernel.sum()


class PseudoSR:
    """gaussian consistency (pseudoSR.py:47-295): the demo's 25×25 blur
    (kernels_12.mat cell [0, 3]) recentred and ×4 decimated; the
    correction is the null-space step A⁺A(x0) − A⁺(y), where A⁺ filters by
    inv(hᵀh) (inverted in the Fourier domain with a magnitude floor of
    0.01, 36 px zero padding, trimmed to 53 taps) and zero-stuffs back up.
    Filters are correlations with edge (replicate) padding."""

    def __init__(self, device, sf=4):
        from scipy.signal import convolve2d
        blur = np.load(os.path.join(HERE, "blur_kernel_k3.npy"))
        self.sf = sf
        self.pre = sf - sf // 2 - 1                   # decimation phase
        up = np.pad(_center_mass(blur, sf) * sf ** 2,
                    ((sf // 2 - self.pre, 0), (sf // 2 - self.pre, 0)))
        ds = up[::-1, ::-1] / sf ** 2
        hth = convolve2d(ds, np.rot90(ds, 2)) * sf ** 2
        c = int(np.ceil(hth.shape[0] / 2 * 1)) % sf
        phase = (sf if c == 0 else c) - 1
        hth = hth[phase::sf, phase::sf]
        f = np.fft.fft2(np.pad(hth, 18))
        inv = np.real(np.fft.ifft2(1.0 / (f * np.maximum(1.0, 0.01
                                                         / np.abs(f)))))
        n = inv.shape[0]
        r0, c0 = np.unravel_index(np.argmax(inv), inv.shape)
        if not np.all(np.ceil(np.array(inv.shape) / 2)
                      == np.array([r0, c0]) - 1):
            half = int(min(n - r0 - 1, n - c0 - 1, r0, c0))
            inv = inv[r0 - half:r0 + half + 1, c0 - half:c0 + half + 1]
        drop = inv.shape[0] // 2 - 26
        if drop > 0:
            inv = inv[drop:-drop, drop:-drop]

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                device=device)

        self.down_k = dev(np.rot90(ds, 2))
        self.inv_hth = dev(inv.astype(np.float32))
        self.up_k = dev(ds * sf ** 2)

    @staticmethod
    def correlate(x, k):
        """Depthwise correlation of NHWC x with k, edge-padded by k // 2."""
        kh, kw = k.shape
        k = k.to(x.dtype)
        v = F.pad(x.permute(0, 3, 1, 2), (kw // 2, kw // 2, kh // 2, kh // 2),
                  mode="replicate")
        c = v.shape[1]
        return F.conv2d(v, k.expand(c, 1, kh, kw).contiguous(), groups=c).permute(
            0, 2, 3, 1)

    def pinv(self, lr):
        n, h, w, c = lr.shape
        up = lr.new_zeros((n, h, self.sf, w, self.sf, c))
        up[:, :, self.pre, :, self.pre] = self.correlate(lr, self.inv_hth)
        return self.correlate(up.reshape(n, h * self.sf, w * self.sf, c),
                              self.up_k)

    def correction(self, x0, y):
        down = self.correlate(x0, self.down_k)[:, self.pre::self.sf,
                                               self.pre::self.sf]
        return self.pinv(down) - self.pinv(y)


class Guidance:
    """One task's respaced schedule, consistency operator and, for a task
    with a face prior, the fusion weights of its face window."""

    def __init__(self, task, steps, size, device):
        self.task = task
        self.acp, self.timestep_map, self.gammas = respaced(task, steps)
        self.op = (SRConv(size, 8, device) if task == "x8_bicubic"
                   else PseudoSR(device))
        if task in face_ref.TASKS:
            self.ws, self.tau = face_ref.window(task, len(self.acp))

    def in_face_window(self, t) -> bool:
        return hasattr(self, "tau") and self.tau <= t <= len(self.acp) - 1

    def start(self, init, noise):
        """x_T = q_sample(init, T−1, noise)."""
        a = float(self.acp[-1])
        return a ** 0.5 * init + (1 - a) ** 0.5 * noise

    def x0(self, x, out, t, y):
        """x0 from eps (the first 3 channels of ``out``), clipped; then
        x0 − γ_t·correction, clipped. x (B, T, H, W, 3), y (B·T, h, w, 3)
        in [-1, 1]."""
        a = float(self.acp[t])
        eps = out[..., :3]
        x0 = (x / a ** 0.5 - (1 / a - 1) ** 0.5 * eps).clamp(-1, 1)
        flat = x0.reshape(-1, *x0.shape[2:])
        return (x0 - float(self.gammas[t]) * self.op.correction(
            flat, y).reshape(x0.shape)).clamp(-1, 1)

    def update(self, x, out, t, y, pin_values=None, face=None):
        """The guided η = 0 DDIM step at spaced step t: ``x0``; in the face
        window, with ``face`` = (restored faces (B·T, S, S, 3), their parse
        logits or None, the (B·T, 2, 3) frame → face matrices), x0 ←
        w_t·x0 + (1 − w_t)·clip(the faces pasted into x0); the first
        frames replaced by ``pin_values`` (B, k, H, W, 3); then x_{t−1}."""
        a = float(self.acp[t])
        a_prev = float(self.acp[t - 1]) if t > 0 else 1.0
        x0 = self.x0(x, out, t, y)
        if face is not None and self.in_face_window(t):
            restored, logits, mats = face
            fused = face_ref.fuse(x0.reshape(-1, *x0.shape[2:]), restored,
                                  face_ref.paste_mask(restored, logits), mats)
            w = float(self.ws[t])
            x0 = w * x0 + (1 - w) * fused.clamp(-1, 1).reshape(x0.shape)
        if pin_values is not None:
            x0 = torch.cat([pin_values, x0[:, pin_values.shape[1]:]], 1)
        eps = (x / a ** 0.5 - x0) / (1 / a - 1) ** 0.5
        return a_prev ** 0.5 * x0 + (t > 0) * (1 - a_prev) ** 0.5 * eps
