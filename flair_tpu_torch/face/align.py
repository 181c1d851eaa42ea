"""5-point reference alignment (facelib/detection/{align_trans,
matlab_cp2tform}.py).

Counterpart of ``flair_tpu/face/align.py``, whose numpy geometry it copies:
``get_reference_facial_points`` produces the canonical 5-landmark template
(96×112 inner crop, optionally square-padded); ``cp2tform`` is the MATLAB
similarity estimator (non-reflective + reflected candidate, pick the lower
residual); ``warp_and_crop_face`` applies the transform with
``ops.warp.warp_affine`` on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np

# canonical 5 facial points in a 96×112 crop (align_trans REFERENCE_FACIAL_POINTS)
REFERENCE_FACIAL_POINTS = np.array(
    [
        [30.29459953, 51.69630051],
        [65.53179932, 51.50139999],
        [48.02519989, 71.73660278],
        [33.54930115, 92.3655014],
        [62.72990036, 92.20410156],
    ],
    np.float32,
)
DEFAULT_CROP_SIZE = (96, 112)


def get_reference_facial_points(
    output_size=None,
    inner_padding_factor: float = 0.0,
    outer_padding=(0, 0),
    default_square: bool = False,
) -> np.ndarray:
    """(align_trans.get_reference_facial_points semantics)."""
    tmp_5pts = REFERENCE_FACIAL_POINTS.copy()
    tmp_crop = np.array(DEFAULT_CROP_SIZE, np.float32)

    if default_square:
        size_diff = tmp_crop.max() - tmp_crop
        tmp_5pts += size_diff / 2
        tmp_crop += size_diff

    if (
        output_size
        and output_size[0] == tmp_crop[0]
        and output_size[1] == tmp_crop[1]
    ):
        return tmp_5pts
    if inner_padding_factor == 0 and outer_padding == (0, 0):
        if output_size is None:
            return tmp_5pts
        raise ValueError("No paddings to do, output_size must be None or "
                         f"{tuple(tmp_crop)}")
    if not 0 <= inner_padding_factor <= 1.0:
        raise ValueError("inner_padding_factor must be in [0, 1]")
    if (inner_padding_factor > 0 or outer_padding != (0, 0)) and output_size is None:
        output_size = (tmp_crop * (1 + inner_padding_factor * 2)).astype(np.int32)
        output_size += np.array(outer_padding)
    if not (outer_padding[0] < output_size[0] and outer_padding[1] < output_size[1]):
        raise ValueError("outer_padding must be smaller than output_size")

    if inner_padding_factor > 0:
        size_diff = tmp_crop * inner_padding_factor * 2
        tmp_5pts += size_diff / 2
        tmp_crop += np.round(size_diff).astype(np.int32)

    size_bf_outer = np.array(output_size) - np.array(outer_padding) * 2
    if size_bf_outer[0] * tmp_crop[1] != size_bf_outer[1] * tmp_crop[0]:
        raise ValueError("padding must keep the aspect ratio")
    scale = size_bf_outer[0].astype(np.float32) / tmp_crop[0]
    tmp_5pts = tmp_5pts * scale
    tmp_5pts += np.array(outer_padding)
    return tmp_5pts


def _nonreflective_similarity(uv: np.ndarray, xy: np.ndarray):
    """matlab_cp2tform.findNonreflectiveSimilarity: solve for
    [sc, ss, tx, ty] mapping uv → xy."""
    n = xy.shape[0]
    x = xy[:, 0:1]
    y = xy[:, 1:2]
    ones = np.ones((n, 1))
    zeros = np.zeros((n, 1))
    X = np.vstack(
        [np.hstack([x, y, ones, zeros]), np.hstack([y, -x, zeros, ones])]
    )
    u = uv[:, 0:1]
    v = uv[:, 1:2]
    U = np.vstack([u, v]).ravel()
    r, *_ = np.linalg.lstsq(X, U, rcond=None)
    sc, ss, tx, ty = r
    tinv = np.array([[sc, -ss, 0], [ss, sc, 0], [tx, ty, 1]])
    t = np.linalg.inv(tinv)
    t[:, 2] = [0, 0, 1]
    return t, tinv


def cp2tform(src_pts: np.ndarray, dst_pts: np.ndarray, reflective: bool = True):
    """MATLAB cp2tform('similarity') port: returns the 2x3 affine matrix
    mapping src → dst (matlab_cp2tform.get_similarity_transform)."""
    src = np.asarray(src_pts, np.float64)
    dst = np.asarray(dst_pts, np.float64)
    trans1, _ = _nonreflective_similarity(src, dst)
    if reflective:
        # reflect dst over x, solve, reflect back, compare residuals
        dst_r = dst.copy()
        dst_r[:, 0] = -dst_r[:, 0]
        trans2r, _ = _nonreflective_similarity(src, dst_r)
        reflect = np.diag([-1.0, 1.0, 1.0])
        trans2 = trans2r @ reflect

        def resid(t):
            pts = np.hstack([src, np.ones((src.shape[0], 1))]) @ t
            return np.linalg.norm(pts[:, :2] - dst)

        trans = trans1 if resid(trans1) <= resid(trans2) else trans2
    else:
        trans = trans1
    return trans[:, :2].T  # 2x3 cv2-style


def warp_and_crop_face(
    src_img,
    facial_pts,
    reference_pts=None,
    crop_size=(112, 112),
    align_type: str = "similarity",
    device=None,
):
    """Crop a face by 5-point alignment (align_trans.warp_and_crop_face).

    src_img: (H, W, C) numpy array or tensor in any range; returns the
    warped crop as numpy and the 2×3 transform. ``ops.warp_affine`` runs on
    ``device``: by default a tensor's own device, and cuda for numpy.
    """
    import torch

    from ..ops.warp import warp_affine
    from ..utils.device import resolve_device

    if reference_pts is None:
        reference_pts = get_reference_facial_points(
            output_size=crop_size, default_square=crop_size[0] == crop_size[1]
        )
    if align_type == "affine":
        # full 6-dof affine via lstsq
        src = np.asarray(facial_pts, np.float64)
        dst = np.asarray(reference_pts, np.float64)
        A = np.hstack([src, np.ones((src.shape[0], 1))])
        sol, *_ = np.linalg.lstsq(A, dst, rcond=None)
        tfm = sol.T
    else:
        tfm = cp2tform(np.asarray(facial_pts), np.asarray(reference_pts))
    if device is None and isinstance(src_img, torch.Tensor):
        device = src_img.device
    dev = resolve_device(device)
    img = torch.as_tensor(src_img, dtype=torch.float32, device=dev)[None]
    m = torch.as_tensor(np.asarray(tfm, np.float32), device=dev)[None]
    out = warp_affine(img, m, (crop_size[1], crop_size[0]))
    return out[0].cpu().numpy(), tfm
