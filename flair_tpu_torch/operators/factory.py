"""Per-task degradation operator and data-consistency closures.

Counterpart of ``flair_tpu/operators/factory.py`` (scripts/video_sample.py
:177-263):
- x8/x16_bicubic → SRConv with an a=-0.5 bicubic kernel of length
  4·factor; the correction is A⁺(A(x) − y) (gaussian_diffusion.py:465-470);
- gaussian/jpeg → PseudoSR ×4 with the 25×25 demo blur kernel
  (kernels_12.mat cell [0, 3], the port's copy in
  ``flair_tpu_torch/assets/blur_kernels.npz``), kernel_indx=10; the
  correction is the null-space A⁺A(x) − A⁺(y), with the JPEG round-trip
  for the jpeg task.
"""

from __future__ import annotations

import os

import numpy as np

from .pseudo_sr import PseudoSR, get_pseudo_sr_conf
from .svd_ops import SRConv

BICUBIC_TASKS = ("x8_bicubic", "x16_bicubic")
BLUR_TASKS = ("gaussian", "jpeg")
_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def bicubic_kernel_1d(factor: int, a: float = -0.5) -> np.ndarray:
    """Length-4·factor bicubic antialiasing kernel sampled at half-pixel
    offsets (scripts/video_sample.py:210-224), normalised to sum 1."""
    i = np.arange(factor * 4, dtype=np.float64)
    x = (1.0 / factor) * (i - np.floor(factor * 4 / 2) + 0.5)
    ax = np.abs(x)
    k = np.where(
        ax <= 1,
        (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a,
                 0.0))
    return k / k.sum()


def load_blur_kernel(index: int = 3) -> np.ndarray:
    """Demo blur kernel (miscs/kernels_12.mat cell [0, index], 25×25)."""
    with np.load(os.path.join(_ASSET_DIR, "blur_kernels.npz")) as data:
        return np.asarray(data[f"k{index}"], np.float64)


def get_operator(task: str, img_dim: int = 512, device=None):
    """The task's A-operator on ``device`` (``cuda`` unless the caller asks
    for the CPU)."""
    if task in BICUBIC_TASKS:
        factor = 8 if task == "x8_bicubic" else 16
        return SRConv(bicubic_kernel_1d(factor), channels=3, img_dim=img_dim,
                      stride=factor, device=device)
    if task in BLUR_TASKS:
        return PseudoSR(get_pseudo_sr_conf(4), blur_kernel=load_blur_kernel(3),
                        kernel_indx=10, device=device)
    raise ValueError(f"unknown task: {task}")


def make_restore_fn(task: str, operator, degraded, jpeg_qf: int = -1):
    """x0 (N, H, W, C) in [-1, 1] ↦ its data-consistency correction, with
    the observed LR frames ``degraded`` (N, h, w, C) bound."""
    restore = make_restore_fn_p(task, operator, jpeg_qf)
    return lambda x0: restore(x0, degraded)


def make_restore_fn_p(task: str, operator, jpeg_qf: int = -1):
    """``restore(x0, degraded)``: the observation enters per call.
    ``jpeg_qf`` (the jpeg task only; -1 = none) puts the JPEG round-trip
    into the correction."""
    if task in BICUBIC_TASKS:
        def restore(x0, degraded):
            n = x0.shape[0]
            resid = operator.A(x0.reshape(n, -1)) - degraded.reshape(n, -1)
            return operator.A_pinv(resid).reshape(x0.shape)

        return restore
    if task in BLUR_TASKS:
        qf = jpeg_qf if task == "jpeg" and jpeg_qf != -1 else None

        def restore(x0, degraded):
            return operator.A_pinv(degraded, x0, jpeg_qf=qf)

        return restore
    raise ValueError(f"unknown task: {task}")
