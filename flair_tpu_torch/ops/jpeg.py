"""Differentiable JPEG codec on NHWC tensors.

Counterpart of ``flair_tpu/ops/jpeg.py`` (reference
guided_diffusion/jpeg.py:7-187), with the uniform ``quantization_encode`` /
``_decode`` codec. The encoded form is a pair ``(luma, chroma)``: luma
(B, H, W, 1) and chroma (B, H/2, W/2, 2) of quantised DCT coefficients laid
out as 8×8 spatial blocks.

- Chroma is subsampled top-left (``[::2, ::2]``) before the transform and
  decoded by 2×2 repetition (jpeg.py:31, 152-157).
- Quantisation rounds half to even (``torch.round`` as ``jnp.round``). A
  coefficient that sits at .5 can still flip between two implementations
  whose float sums differ in the last bit, so a round-trip agrees with the
  JAX package up to such flips, not bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dct import block_dct8, block_idct8

# RGB↔YCbCr matrices (jpeg.py:7-28).
_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114], [-0.1687, -0.3313, 0.5], [0.5, -0.4187, -0.0813]],
    dtype=np.float32)
_YCBCR2RGB = np.array(
    [[1.00000000e00, -3.68199903e-05, 1.40198758e00],
     [1.00000000e00, -3.44113281e-01, -7.14103821e-01],
     [1.00000000e00, 1.77197812e00, -1.34583413e-04]],
    dtype=np.float32)
_CHROMA_OFFSET = (0.0, 128.0, 128.0)

# Standard JPEG base quantisation tables (jpeg.py:35-58).
_Q_LUMA = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)
_Q_CHROMA = np.full((8, 8), 99.0)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                     [24, 26, 56, 99], [47, 66, 99, 99]]


@functools.lru_cache(maxsize=None)
def quantization_matrix(qf: int) -> tuple[np.ndarray, np.ndarray]:
    """Quality-scaled (luma, chroma) quantisation matrices (jpeg.py:35-69)."""
    s = (5000 / qf) if qf < 50 else (200 - 2 * qf)
    q1 = np.floor((s * _Q_LUMA + 50) / 100)
    q2 = np.floor((s * _Q_CHROMA + 50) / 100)
    return np.clip(q1, 1, 255), np.clip(q2, 1, 255)


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 255] → YCbCr, chroma offset +128 (jpeg.py:7-14)."""
    m = torch.as_tensor(_RGB2YCBCR, dtype=x.dtype, device=x.device)
    off = torch.as_tensor(_CHROMA_OFFSET, dtype=x.dtype, device=x.device)
    return torch.einsum("...c,kc->...k", x, m) + off


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """YCbCr → RGB in [0, 255] (jpeg.py:17-28)."""
    m = torch.as_tensor(_YCBCR2RGB, dtype=x.dtype, device=x.device)
    off = torch.as_tensor(_CHROMA_OFFSET, dtype=x.dtype, device=x.device)
    return torch.einsum("...c,kc->...k", x - off, m)


def _qtable(q: np.ndarray, coef: torch.Tensor) -> torch.Tensor:
    h, w = coef.shape[-2:]
    return torch.as_tensor(np.tile(q, (h // 8, w // 8)), dtype=coef.dtype,
                           device=coef.device)


def jpeg_encode(x: torch.Tensor, qf: int):
    """RGB (B, H, W, 3) in [-1, 1] → ``(luma (B, H, W, 1), chroma
    (B, H/2, W/2, 2))`` quantised DCT planes (jpeg.py:72-114)."""
    ycc = rgb_to_ycbcr((x + 1.0) / 2.0 * 255.0)
    q1, q2 = quantization_matrix(qf)

    def encode_plane(p, q):
        coef = block_dct8((p - 128.0).permute(0, 3, 1, 2))   # (B, C, H, W)
        return torch.round(coef / _qtable(q, coef)).permute(0, 2, 3, 1)

    return (encode_plane(ycc[..., :1], q1),
            encode_plane(ycc[:, ::2, ::2, 1:], q2))


def jpeg_decode(planes, qf: int) -> torch.Tensor:
    """Quantised DCT planes → RGB (B, H, W, 3) in [-1, 1] (jpeg.py:117-167)."""
    luma, chroma = planes
    q1, q2 = quantization_matrix(qf)

    def decode_plane(p, q):
        coef = p.permute(0, 3, 1, 2)
        return (block_idct8(coef * _qtable(q, coef)) + 128.0).permute(0, 2, 3, 1)

    y = decode_plane(luma, q1)
    cc = decode_plane(chroma, q2)
    cc = cc.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return ycbcr_to_rgb(torch.cat([y, cc], dim=-1)) / 255.0 * 2.0 - 1.0


def quantization_encode(x: torch.Tensor, qf: int = 32) -> torch.Tensor:
    """Uniform value quantization of x in [-1, 1] (jpeg.py:170-186). The
    reference forces qf = 32 whatever it is given, kept here; its
    ``x.int()`` truncates toward zero (an int32 cast, not a floor, which
    differs on negatives)."""
    qf = 32
    v = ((x + 1.0) / 2.0 * 255.0).to(torch.int32)
    v = torch.div(v, qf, rounding_mode="floor").float() / (255.0 / qf)
    return v * 2.0 - 1.0


def quantization_decode(x: torch.Tensor, qf: int = 32) -> torch.Tensor:
    """Identity (jpeg.py:186-187): uniform quantization has no decode."""
    return x
