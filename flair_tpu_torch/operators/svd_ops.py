"""SVD-decomposed linear degradation operators.

Counterpart of ``AFunctions`` and ``SRConv`` in
``flair_tpu/operators/svd_ops.py`` (reference restore_util.py:11-227). The
SVD of the 1-D bicubic conv + decimation matrix is built on the host in
float64 (the port keeps its own copy of that code); the 2-D operator follows
by Kronecker structure plus an index permutation, applied on the device as
small separable matmuls.

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
