"""The DCT as dense matmuls.

Counterpart of ``flair_tpu/ops/dct.py`` (reference guided_diffusion/dct.py:
6-215, whose LinearDCT materialises the transforms as matrices anyway): each
transform matrix is built on the host in float64, cast to the input's dtype
and applied with einsum.

- ``dct`` / ``idct`` (DCT-II and its inverse over the last axis, ``norm``
  None or ``"ortho"``), their 2-D and 3-D forms over the last two / three
  axes, and ``dct1`` / ``idct1`` (DCT-I);
- ``block_dct8`` / ``block_idct8``: the orthonormal 8×8 block DCT of an
  (..., H, W) plane, the JPEG codec's transform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int, norm: str | None) -> np.ndarray:
    """DCT-II matrix D with (D @ x) == dct(x) over the last axis."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * i + 1.0) / (2.0 * n))
    if norm == "ortho":
        mat[0] /= np.sqrt(n) * 2.0
        mat[1:] /= np.sqrt(n / 2.0) * 2.0
    return mat


def dct_matrix(n: int, kind: str = "dct", norm: str | None = "ortho") -> np.ndarray:
    """The (n, n) float64 DCT-II matrix, or its inverse for ``kind="idct"``
    (idct(dct(x)) == x, LinearDCT('idct'), dct.py:167-189)."""
    d = _dct_matrix_np(n, norm)
    if kind == "dct":
        return d.copy()
    if kind == "idct":
        return np.linalg.inv(d)
    raise ValueError(f"unknown DCT kind: {kind}")


def _apply(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``m`` (float64, host) over the last axis of x, in x's dtype."""
    mt = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    return torch.einsum("ki,...i->...k", mt, x)


def dct(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """DCT-II over the last axis (dct.py:31-61)."""
    return _apply(_dct_matrix_np(x.shape[-1], norm), x)


def idct(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """Inverse of :func:`dct` (DCT-III up to scale; dct.py:64-104)."""
    return _apply(np.linalg.inv(_dct_matrix_np(x.shape[-1], norm)), x)


def dct1(x: torch.Tensor) -> torch.Tensor:
    """DCT-I over the last axis (dct.py:6-17)."""
    n = x.shape[-1]
    i = np.arange(n, dtype=np.float64)
    m = np.cos(np.pi * i[:, None] * i[None, :] / (n - 1))
    m = m * np.where((i[None, :] == 0) | (i[None, :] == n - 1), 1.0, 2.0)
    return _apply(m, x)


def idct1(x: torch.Tensor) -> torch.Tensor:
    """Inverse DCT-I: idct1(dct1(x)) == x (dct.py:20-28)."""
    return dct1(x) / (2 * (x.shape[-1] - 1))


def _apply_2d(m_h: np.ndarray, m_w: np.ndarray, x: torch.Tensor):
    mh = torch.as_tensor(m_h, dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(m_w, dtype=x.dtype, device=x.device)
    return torch.einsum("uh,...hw,vw->...uv", mh, x, mw)


def dct_2d(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """2-D DCT-II over the last two axes (dct.py:107-118)."""
    return _apply_2d(_dct_matrix_np(x.shape[-2], norm),
                     _dct_matrix_np(x.shape[-1], norm), x)


def idct_2d(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """Inverse 2-D DCT (dct.py:121-133)."""
    return _apply_2d(np.linalg.inv(_dct_matrix_np(x.shape[-2], norm)),
                     np.linalg.inv(_dct_matrix_np(x.shape[-1], norm)), x)


def dct_3d(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """DCT-II over the last three axes (dct.py:136-149)."""
    y = dct(x, norm)
    y = dct(y.transpose(-1, -2), norm).transpose(-1, -2)
    return dct(y.transpose(-1, -3), norm).transpose(-1, -3)


def idct_3d(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """Inverse of :func:`dct_3d` (dct.py:151-165)."""
    y = idct(x, norm)
    y = idct(y.transpose(-1, -2), norm).transpose(-1, -2)
    return idct(y.transpose(-1, -3), norm).transpose(-1, -3)


def _block_transform(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    *lead, h, w = x.shape
    d = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    blocks = x.reshape(*lead, h // 8, 8, w // 8, 8)
    out = torch.einsum("uh,...ahbw,vw->...aubv", d, blocks, d)
    return out.reshape(*lead, h, w)


def block_dct8(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 8×8 block DCT of an (..., H, W) plane, H, W % 8 == 0
    (unfold → LinearDCT → fold of jpeg.py:86-96)."""
    return _block_transform(x, _dct_matrix_np(8, "ortho"))


def block_idct8(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_dct8` (jpeg.py:134-141)."""
    return _block_transform(x, np.linalg.inv(_dct_matrix_np(8, "ortho")))
