"""Per-task degradation operator and data-consistency closures.

Counterpart of ``flair_tpu/operators/factory.py`` for the bicubic tasks:
x8/x16_bicubic → SRConv with an a=-0.5 bicubic kernel of length 4·factor
(scripts/video_sample.py:205-224). The correction is A⁺(A(x) − y)
(gaussian_diffusion.py:465-470). The gaussian/jpeg tasks (PseudoSR) are not
in this package yet.
"""

from __future__ import annotations

import numpy as np

from .svd_ops import SRConv

BICUBIC_TASKS = ("x8_bicubic", "x16_bicubic")


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


def get_operator(task: str, img_dim: int = 512, device=None):
    """The task's A-operator on ``device`` (``cuda`` unless the caller asks
    for the CPU)."""
    if task not in BICUBIC_TASKS:
        raise ValueError(f"task {task!r} is not in this package yet "
                         f"(have {BICUBIC_TASKS})")
    factor = 8 if task == "x8_bicubic" else 16
    return SRConv(bicubic_kernel_1d(factor), channels=3, img_dim=img_dim,
                  stride=factor, device=device)


def make_restore_fn(task: str, operator, degraded):
    """x0 (N, H, W, C) ↦ A⁺(A(x0) − y) with the observed LR frames
    ``degraded`` (N, h, w, C) bound."""
    restore = make_restore_fn_p(task, operator)
    return lambda x0: restore(x0, degraded)


def make_restore_fn_p(task: str, operator):
    """``restore(x0, degraded)``: the observation enters per call."""
    if task not in BICUBIC_TASKS:
        raise ValueError(f"task {task!r} is not in this package yet")

    def restore(x0, degraded):
        n = x0.shape[0]
        resid = operator.A(x0.reshape(n, -1)) - degraded.reshape(n, -1)
        return operator.A_pinv(resid).reshape(x0.shape)

    return restore
