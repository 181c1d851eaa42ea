"""8×8 block DCT as dense matmuls (the JPEG codec's transform).

Counterpart of ``dct_matrix``, ``block_dct8`` and ``block_idct8`` in
``flair_tpu/ops/dct.py`` (reference guided_diffusion/dct.py:167-215
LinearDCT): the orthonormal DCT-II matrix is built on the host in float64
and applied with einsum over 8×8 blocks of an (..., H, W) plane.
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
