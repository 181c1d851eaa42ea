"""Face restoration helper: align on the host, crop → restore → mask →
paste back on the device.

Counterpart of ``flair_tpu/face/helper.py`` (reference
facelib/utils/face_restoration_helper.py:64-335). The affine matrices are
computed once per window on the host (detection + similarity transform);
the per-step crop → CodeFormer → ParseNet mask → blur → inverse paste runs
on the device inside the sampler step (``ops.warp_affine``,
``ops.gaussian_blur``), with no host round trip. The host geometry below
is a copy of the JAX package's numpy code: the port imports nothing of it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.blur import gaussian_blur
from ..ops.warp import invert_affine_batch, warp_affine

# standard 5 landmarks for FFHQ 512² faces (face_restoration_helper.py:91-99)
FFHQ_TEMPLATE_512 = np.array(
    [
        [192.98138, 239.94708],
        [318.90277, 240.1936],
        [256.63416, 314.01935],
        [201.26117, 371.41043],
        [313.08905, 371.15118],
    ],
    dtype=np.float64,
)

# 19-class parsing → paste mask (face_restoration_helper.py:281-302):
# classes 1-13 are the face region; 0 and 14-18 (background, hair, ears,
# neck, cloth) are not.
MASK_COLORMAP = np.array([0] + [1] * 13 + [0] * 5, dtype=np.float32)

_GRAY_BORDER = np.array([135.0, 133.0, 132.0], np.float32) / 255.0 * 2.0 - 1.0
_MASK_BORDER = 10   # pixels of the blurred mask zeroed at the crop's edge


def estimate_similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (rotation + scale + translation), the
    deterministic core of cv2.estimateAffinePartial2D(method=LMEDS) for
    the 5-point alignment (face_restoration_helper.py:198-200): with 5
    correspondences and no outliers LMEDS reduces to this solution."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    a = np.zeros((2 * n, 4))
    b = np.zeros(2 * n)
    a[0::2, 0] = src[:, 0]
    a[0::2, 1] = -src[:, 1]
    a[0::2, 2] = 1
    a[1::2, 0] = src[:, 1]
    a[1::2, 1] = src[:, 0]
    a[1::2, 3] = 1
    b[0::2] = dst[:, 0]
    b[1::2] = dst[:, 1]
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    cos_s, sin_s, tx, ty = sol
    return np.array([[cos_s, -sin_s, tx], [sin_s, cos_s, ty]], np.float64)


def get_largest_face(boxes: np.ndarray, h: int, w: int) -> int:
    """Index of the largest detected face (face_restoration_helper.py:31-43)."""
    def area(b):
        left, top = max(b[0], 0), max(b[1], 0)
        right, bottom = min(b[2], w), min(b[3], h)
        return (right - left) * (bottom - top)

    return int(np.argmax([area(b) for b in boxes]))


class FaceRestoreHelper:
    """Host-side geometry. ``detector``: any object with
    ``detect_faces(image_bgr) → (N, 15)`` detections (box, score, 5
    landmarks), or None to detect nothing."""

    def __init__(self, detector=None, face_size: int = 512,
                 template: np.ndarray = FFHQ_TEMPLATE_512):
        self.detector = detector
        self.face_size = face_size
        self.template = template * (face_size / 512.0)

    def get_affine_matrices(self, frames01: np.ndarray,
                            only_keep_largest: bool = True,
                            eye_dist_threshold: float = 0.1,
                            ) -> list[Optional[np.ndarray]]:
        """Per-frame affine matrix mapping the frame onto the template
        (face_restoration_helper.py:150-211). ``frames01``: (T, H, W, 3) RGB
        in [0, 1]. Frames with no face get None."""
        mats: list[Optional[np.ndarray]] = []
        for img in frames01:
            bgr = (img[..., ::-1] * 255.0).astype(np.float32)
            dets = (self.detector.detect_faces(bgr) if self.detector
                    else np.zeros((0, 15)))
            landmarks, boxes = [], []
            for det in dets:
                eye_dist = np.linalg.norm([det[5] - det[7], det[6] - det[8]])
                if (eye_dist_threshold is not None
                        and eye_dist < eye_dist_threshold):
                    continue
                landmarks.append(det[5:15].reshape(5, 2))
                boxes.append(det[:5])
            if not boxes:
                mats.append(None)
                continue
            idx = (get_largest_face(np.asarray(boxes), img.shape[0],
                                    img.shape[1])
                   if only_keep_largest else 0)
            mats.append(estimate_similarity_transform(landmarks[idx],
                                                      self.template))
        return mats


def make_face_fn(matrices, codeformer_apply: Callable,
                 parsenet_apply: Optional[Callable] = None, *,
                 face_size: int = 512, fidelity_w: float = 1.0,
                 aligned: bool = False) -> Callable:
    """The sampler's face fusion with fixed matrices: ``face_fn(x0, x_t)``
    (see :func:`make_face_fn_p`; ``matrices`` (T, 2, 3), host or device)."""
    mats = torch.as_tensor(np.asarray(matrices, np.float32))
    fn_p = make_face_fn_p(codeformer_apply, parsenet_apply,
                          face_size=face_size, aligned=aligned)

    def face_fn(x0, x_t):
        return fn_p(x0, x_t, mats.to(x0.device))

    return face_fn


def make_face_fn_p(codeformer_apply: Callable,
                   parsenet_apply: Optional[Callable] = None, *,
                   face_size: int = 512, fidelity_w: float = 1.0,
                   aligned: bool = False) -> Callable:
    """``face_fn(x0, x_t, mats)`` for the sampler: x0 (B, T, H, W, 3) in
    [-1, 1] → the fused frames, with the reference fusion
    (gaussian_diffusion.py:471-494): fused = x0·(1−m) + face·m.

    ``mats``: (T, 2, 3), tiled over the batch, or (B, T, 2, 3) / (B·T, 2, 3)
    per clip, on x0's device. ``codeformer_apply(faces)``: (N, S, S, 3) →
    restored faces in [-1, 1] (NHWC, S = ``face_size``);
    ``parsenet_apply(faces)`` → (N, S, S, 19) logits, or None for a full
    mask. ``aligned``: x0's frames are the faces already. ``fidelity_w``
    is taken, as the JAX package takes it, and not read: CodeFormer's
    fidelity is fixed when ``codeformer_apply`` is built."""

    def face_fn(x0, x_t, mats):
        b, t, h, w, c = x0.shape
        frames = x0.reshape(b * t, h, w, c)
        if aligned:
            return codeformer_apply(frames).reshape(b, t, h, w, c)
        m = mats.reshape(-1, 2, 3)
        if m.shape[0] != b * t:
            m = m.repeat(b, 1, 1)
        border = torch.as_tensor(_GRAY_BORDER, dtype=x0.dtype,
                                 device=x0.device)
        # crop with a gray constant border (face_restoration_helper.py:203-209)
        crop = warp_affine(frames - border, m, (face_size, face_size),
                           mode="bicubic") + border
        restored = codeformer_apply(crop.clamp(-1, 1))
        if parsenet_apply is not None:
            # the reference parses the RAW CodeFormer output (:265)
            classes = torch.argmax(parsenet_apply(restored), dim=-1)
            mask = torch.as_tensor(MASK_COLORMAP,
                                   device=restored.device)[classes][..., None]
        else:
            mask = torch.ones_like(restored[..., :1])
        # two 101 / 26 gaussian blurs, then a zeroed 10-px border
        # (face_restoration_helper.py:303-313)
        mask = gaussian_blur(gaussian_blur(mask, 101, 26.0), 101, 26.0)
        e = _MASK_BORDER
        mask = F.pad(mask[:, e:-e, e:-e], (0, 0, e, e, e, e))
        # inverse paste (:314-335): the warp takes the CLAMPED face (the
        # reference's 0..1 normalisation clips) and its result is clamped
        # again; face and mask share the matrices and the output grid, so
        # they ride one C = 4 warp
        pasted = warp_affine(torch.cat([restored.clamp(-1, 1), mask], -1),
                             invert_affine_batch(m), (h, w), mode="bicubic")
        inv_face = pasted[..., :3].clamp(-1, 1)
        inv_mask = pasted[..., 3:]
        fused = frames * (1.0 - inv_mask) + inv_face * inv_mask
        return fused.reshape(b, t, h, w, c)

    return face_fn
