"""SVD-decomposed linear degradation operators.

Counterpart of ``flair_tpu/operators/svd_ops.py`` (reference
restore_util.py:11-471): ``AFunctions``, ``SRConv`` and the patch-average
``SuperResolution`` with DDRM's Λ-operators. The SVD of the 1-D bicubic
conv + decimation matrix is built on the host in float64 (the port keeps
its own copy of that code); the 2-D operator follows by Kronecker structure
plus an index permutation, applied on the device as small separable
matmuls.

Vectors are flattened NHWC images (B, H·W·C), channel fastest — the JAX
package's convention; the permutation bookkeeping is internal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


class AFunctions:
    """SVD operator interface: subclasses implement V, Vt, U, Ut,
    singulars and add_zeros on flattened batches (B, D)."""

    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self):
        raise NotImplementedError

    def add_zeros(self, vec):
        raise NotImplementedError

    def A(self, vec):
        s = self.singulars()
        return self.U(s * self.Vt(vec)[:, :s.shape[0]])

    def At(self, vec):
        s = self.singulars()
        return self.V(self.add_zeros(s * self.Ut(vec)[:, :s.shape[0]]))

    def A_pinv(self, vec):
        s = self.singulars()
        factors = torch.where(s != 0, 1.0 / torch.where(s != 0, s, 1.0),
                              torch.zeros_like(s))
        tmp = self.Ut(vec).clone()
        tmp[:, :s.shape[0]] *= factors
        return self.V(self.add_zeros(tmp))

    def A_pinv_eta(self, vec, eta: float):
        """A⁺ regularised by ``eta``: s / (s² + η) on the singular
        coordinates."""
        s = self.singulars()
        tmp = self.Ut(vec).clone()
        tmp[:, :s.shape[0]] *= s / (s * s + eta)
        return self.V(self.add_zeros(tmp))


def _build_srconv_matrix(kernel: np.ndarray, img_dim: int,
                         stride: int) -> np.ndarray:
    """1-D conv + decimation matrix with reflection padding
    (restore_util.py:112-133), float64."""
    small = img_dim // stride
    a = np.zeros((small, img_dim), dtype=np.float64)
    klen = kernel.shape[0]
    for i in range(stride // 2, img_dim + stride // 2, stride):
        for j in range(i - klen // 2, i + klen // 2):
            je = j
            if je < 0:
                je = -je - 1
            if je >= img_dim:
                je = (img_dim - 1) - (je - img_dim)
            a[i // stride, je] += kernel[j - i + klen // 2]
    return a


class SRConv(AFunctions):
    """Separable bicubic downsampling operator (restore_util.py:102-227):
    SVD on the host (singular values below 3e-2 zeroed), applied on
    ``device`` (``cuda`` unless the caller asks for the CPU) as (small
    matmul, image, small matmulᵀ) pairs."""

    def __init__(self, kernel: np.ndarray, channels: int, img_dim: int,
                 stride: int, dtype=torch.float32, device=None):
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = stride
        self.y_dim = img_dim // stride
        a_small = _build_srconv_matrix(np.asarray(kernel, np.float64),
                                       img_dim, stride)
        u, s, vt = np.linalg.svd(a_small, full_matrices=True)
        s = s.copy()
        s[s < 3e-2] = 0.0
        dev = resolve_device(device)
        self._u_small = torch.as_tensor(u, dtype=dtype, device=dev)
        self._v_small = torch.as_tensor(vt.T.copy(), dtype=dtype, device=dev)
        sing2d = np.outer(s, s).reshape(-1)
        self._singulars = torch.as_tensor(np.repeat(sing2d, channels),
                                          dtype=dtype, device=dev)
        # permutation: singular-value ordering ↔ raster ordering
        # (restore_util.py:146-160); uncovered rows keep their position
        perm = [img_dim * i + j for i in range(self.y_dim)
                for j in range(self.y_dim)] + [
            img_dim * i + j for i in range(self.y_dim)
            for j in range(self.y_dim, img_dim)]
        perm_full = np.concatenate([np.asarray(perm, np.int64),
                                    np.arange(len(perm), img_dim ** 2)])
        self._perm_full = torch.as_tensor(perm_full, device=dev)
        self._inv_perm_full = torch.as_tensor(np.argsort(perm_full),
                                              device=dev)

    def _sep_apply(self, img, m):
        """m on rows and mᵀ on cols of (B, d, d, C)."""
        out = torch.einsum("uh,bhwc->buwc", m, img)
        return torch.einsum("vw,bhwc->bhvc", m, out)

    def V(self, vec):
        b, d = vec.shape[0], self.img_dim
        x = vec.reshape(b, d * d, self.channels)[:, self._inv_perm_full, :]
        img = x.reshape(b, d, d, self.channels)
        return self._sep_apply(img, self._v_small).reshape(b, -1)

    def Vt(self, vec):
        b, d = vec.shape[0], self.img_dim
        img = vec.reshape(b, d, d, self.channels)
        out = self._sep_apply(img, self._v_small.T).reshape(
            b, d * d, self.channels)
        return out[:, self._perm_full, :].reshape(b, -1)

    def U(self, vec):
        b = vec.shape[0]
        img = vec.reshape(b, self.y_dim, self.y_dim, self.channels)
        return self._sep_apply(img, self._u_small).reshape(b, -1)

    def Ut(self, vec):
        b = vec.shape[0]
        img = vec.reshape(b, self.y_dim, self.y_dim, self.channels)
        return self._sep_apply(img, self._u_small.T).reshape(b, -1)

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        b = vec.shape[0]
        flat = vec.reshape(b, -1)
        out = torch.zeros((b, flat.shape[1] * self.ratio ** 2),
                          dtype=vec.dtype, device=vec.device)
        out[:, :flat.shape[1]] = flat
        return out


class SuperResolution(AFunctions):
    """Patch-average SR operator with DDRM's Λ-operators
    (restore_util.py:230-471) on ``device`` (``cuda`` unless the caller asks
    for the CPU). A averages each ratio × ratio patch; the SVD of the
    1 × r² row [1/r² … 1/r²], taken on the host in float64 as the JAX
    package takes it, gives U = [u00], σ = 1/r and V (r², r²)."""

    def __init__(self, channels: int, img_dim, ratio: int,
                 dtype=torch.float32, device=None):
        h, w = (img_dim if isinstance(img_dim, (tuple, list))
                else (img_dim, img_dim))
        assert h % ratio == 0 and w % ratio == 0
        self.channels = channels
        self.img_dim = (h, w)
        self.ratio = ratio
        self.y_dim = (h // ratio, w // ratio)
        self.y_pixels = self.y_dim[0] * self.y_dim[1]
        a = np.full((1, ratio ** 2), 1.0 / ratio ** 2, dtype=np.float64)
        u, s, vt = np.linalg.svd(a, full_matrices=True)
        dev = resolve_device(device)
        self._u00 = float(u[0, 0])
        self._sing_small = torch.as_tensor(s, dtype=dtype, device=dev)
        self._v_small = torch.as_tensor(vt.T.copy(), dtype=dtype, device=dev)

    # ordered vector ↔ patch decomposition

    def _extract_patches(self, vec):
        """(B, H·W·C) image → (B, C, y_pixels, r²)."""
        b = vec.shape[0]
        h, w = self.img_dim
        r = self.ratio
        img = vec.reshape(b, h // r, r, w // r, r, self.channels)
        return img.permute(0, 5, 1, 3, 2, 4).reshape(
            b, self.channels, self.y_pixels, r * r)

    def _assemble_patches(self, patches):
        b = patches.shape[0]
        h, w = self.img_dim
        r = self.ratio
        img = patches.reshape(b, self.channels, h // r, w // r, r, r)
        return img.permute(0, 2, 4, 3, 5, 1).reshape(b, -1)

    def _ordered_to_patches(self, vec):
        """The singular-value ordering (restore_util.py:244-262): the first
        C·y_pixels entries are patch component 0, the rest interleave
        components 1..r²-1."""
        b = vec.shape[0]
        n = self.channels * self.y_pixels
        flat = vec.reshape(b, -1)
        head = flat[:, :n].reshape(b, self.channels, self.y_pixels, 1)
        tail = flat[:, n:].reshape(b, self.channels, self.y_pixels, -1)
        return torch.cat([head, tail], dim=-1)

    def _patches_to_ordered(self, patches):
        b = patches.shape[0]
        return torch.cat([patches[..., 0].reshape(b, -1),
                          patches[..., 1:].reshape(b, -1)], dim=1)

    def V(self, vec):
        patches = torch.einsum("ij,bcpj->bcpi", self._v_small,
                               self._ordered_to_patches(vec))
        return self._assemble_patches(patches)

    def Vt(self, vec):
        patches = torch.einsum("ji,bcpj->bcpi", self._v_small,
                               self._extract_patches(vec))
        return self._patches_to_ordered(patches)

    def U(self, vec):
        return self._u00 * vec.reshape(vec.shape[0], -1)

    def Ut(self, vec):
        return self._u00 * vec.reshape(vec.shape[0], -1)

    def singulars(self):
        return self._sing_small.repeat(self.channels * self.y_pixels)

    def add_zeros(self, vec):
        b = vec.shape[0]
        flat = vec.reshape(b, -1)
        out = torch.zeros((b, flat.shape[1] * self.ratio ** 2),
                          dtype=vec.dtype, device=vec.device)
        out[:, :flat.shape[1]] = flat
        return out

    # DDRM Λ-operators (restore_util.py:325-471)

    def _sing_r2(self, like):
        """σ over the r² patch components (σ, 0, …, 0) and its inverse (0
        where σ is 0)."""
        sing = torch.zeros(self.ratio ** 2, dtype=like.dtype,
                           device=like.device)
        sing[:1] = self._sing_small
        inv = torch.where(sing != 0, 1.0 / torch.where(sing != 0, sing, 1.0),
                          torch.zeros_like(sing))
        return sing, inv

    def Lambda(self, vec, a: float, sigma_y: float, sigma_t, eta: float):
        patches = torch.einsum("ji,bcpj->bcpi", self._v_small,
                               self._extract_patches(vec))
        sing, inv_sing = self._sing_r2(vec)
        lam = torch.ones_like(sing)
        if a != 0 and sigma_y != 0:
            change = (sigma_t < a * sigma_y * inv_sing).to(vec.dtype)
            lam = lam * (1 - change) + change * (
                sing * sigma_t * (1 - eta ** 2) ** 0.5 / a / sigma_y)
        patches = torch.einsum("ij,bcpj->bcpi", self._v_small, patches * lam)
        return self._assemble_patches(patches)

    def Lambda_noise(self, vec, a: float, sigma_y: float, sigma_t,
                     eta: float, epsilon):
        pv = self._extract_patches(vec)
        pe = self._extract_patches(epsilon)
        sing, inv_sing = self._sing_r2(vec)
        d1 = torch.full_like(sing, sigma_t * eta)
        d2 = torch.full_like(sing, sigma_t * (1 - eta ** 2) ** 0.5)
        if a != 0 and sigma_y != 0:
            ch = (sigma_t < a * sigma_y * inv_sing).to(vec.dtype)
            d1 = d1 * (1 - ch) + ch * sigma_t * eta
            d2 = d2 * (1 - ch)
            ch = (sigma_t > a * sigma_y * inv_sing).to(vec.dtype)
            d1 = d1 * (1 - ch) + torch.sqrt(ch * torch.clamp_min(
                sigma_t ** 2 - a ** 2 * sigma_y ** 2 * inv_sing ** 2, 0))
            d2 = d2 * (1 - ch)
            ch = (sing == 0).to(vec.dtype)
            d1 = d1 * (1 - ch) + ch * sigma_t * eta
            d2 = d2 * (1 - ch) + ch * sigma_t * (1 - eta ** 2) ** 0.5
        pv = torch.einsum("ij,bcpj->bcpi", self._v_small, pv * d1)
        pe = torch.einsum("ij,bcpj->bcpi", self._v_small, pe * d2)
        return self._assemble_patches(pv) + self._assemble_patches(pe)
