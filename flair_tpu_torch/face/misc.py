"""Host-side facelib utilities (facelib/utils/misc.py).

Counterpart of ``flair_tpu/face/misc.py``, copied: image/array conversion,
grayscale heuristics, numpy AdaIN, directory scanning, image writing and
the URL weight cache. Host numpy only; images are written as PNG through
``utils.png`` (the port has no cv2).
"""

from __future__ import annotations

import os
from urllib.parse import urlparse

import numpy as np


def img2tensor(imgs, bgr2rgb: bool = True, float32: bool = True):
    """HWC BGR uint8/float ndarray(s) → CHW float arrays
    (misc.py:60-86 contract, minus the torch dependency: returns numpy)."""

    def _one(img):
        img = np.asarray(img)
        if img.dtype == np.float64:
            img = img.astype(np.float32)
        if bgr2rgb and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        out = np.ascontiguousarray(img.transpose(2, 0, 1))
        return out.astype(np.float32) if float32 else out

    if isinstance(imgs, (list, tuple)):
        return [_one(i) for i in imgs]
    return _one(imgs)


def tensor2img(arr, rgb2bgr: bool = True, min_max=(0, 1)):
    """CHW float array in [min_max] → HWC uint8 BGR image."""
    a = np.asarray(arr, np.float32)
    a = (a - min_max[0]) / (min_max[1] - min_max[0])
    a = np.clip(a, 0, 1)
    if a.ndim == 3:
        a = a.transpose(1, 2, 0)
    if rgb2bgr and a.ndim == 3 and a.shape[2] == 3:
        a = a[..., ::-1]
    return (a * 255.0).round().astype(np.uint8)


def imwrite(img, file_path: str, params=None, auto_mkdir: bool = True) -> bool:
    """cv2.imwrite of a PNG with parent-dir creation (misc.py:41-57):
    ``img`` (H, W, 3) uint8 BGR, or (H, W) / (H, W, 1) grey. ``params``
    (cv2's encoder flags) are not read. Another extension than .png
    raises."""
    from ..utils.png import write_png

    if not file_path.lower().endswith(".png"):
        raise ValueError(f"imwrite writes PNG only, not {file_path}")
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)), exist_ok=True)
    write_png(file_path, img[..., ::-1])
    return True


def scandir(dir_path: str, suffix=None, recursive: bool = False,
            full_path: bool = False):
    """Generator over files under dir_path (misc.py:108-145)."""
    if suffix is not None and not isinstance(suffix, (str, tuple)):
        raise TypeError("suffix must be a string or tuple of strings")
    root = dir_path

    def _scan(path):
        for entry in os.scandir(path):
            if entry.name.startswith("."):
                continue
            if entry.is_file():
                rel = (entry.path if full_path
                       else os.path.relpath(entry.path, root))
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    return _scan(dir_path)


def is_gray(img: np.ndarray, threshold: int = 10) -> bool:
    """Mean channel-difference heuristic (misc.py:148-162)."""
    img = np.asarray(img)
    if img.ndim == 2 or img.shape[-1] == 1:
        return True
    i = img.astype(np.float64)
    d1 = np.abs(i[..., 0] - i[..., 1]).mean()
    d2 = np.abs(i[..., 1] - i[..., 2]).mean()
    return (d1 + d2) / 2 <= threshold


def rgb2gray(img: np.ndarray, out_channel: int = 3) -> np.ndarray:
    """ITU-R 601 luma with RGB ordering (misc.py:165-171)."""
    g = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return np.stack([g] * out_channel, -1) if out_channel == 3 else g[..., None]


def bgr2gray(img: np.ndarray, out_channel: int = 3) -> np.ndarray:
    """ITU-R 601 luma with BGR ordering (misc.py:173-179)."""
    g = (0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2])
    return np.stack([g] * out_channel, -1) if out_channel == 3 else g[..., None]


def calc_mean_std(feat: np.ndarray, eps: float = 1e-5):
    """Per-(N, C) spatial mean/std of an NCHW array (misc.py:181-192)."""
    n, c = feat.shape[:2]
    v = feat.reshape(n, c, -1)
    var = v.var(axis=2) + eps
    return v.mean(axis=2)[..., None, None], np.sqrt(var)[..., None, None]


def adain_npy(content_feat: np.ndarray, style_feat: np.ndarray) -> np.ndarray:
    """Adaptive instance normalisation on NCHW numpy arrays
    (misc.py:195-210): re-statistics content to match style."""
    size = content_feat.shape
    s_mean, s_std = calc_mean_std(style_feat)
    c_mean, c_std = calc_mean_std(content_feat)
    normalized = (content_feat - np.broadcast_to(c_mean, size)) / (
        np.broadcast_to(c_std, size)
    )
    return normalized * np.broadcast_to(s_std, size) + np.broadcast_to(
        s_mean, size
    )


def load_file_from_url(url: str, model_dir: str | None = None,
                       progress: bool = True,
                       file_name: str | None = None) -> str:
    """Download-and-cache a weight file (misc.py:89-106). Returns the local
    path; skips the download when the cached file exists. Downloads are
    stubbed out gracefully in offline environments (raises URLError)."""
    from urllib.request import urlretrieve

    if model_dir is None:
        model_dir = os.path.join(os.path.expanduser("~"), ".cache",
                                 "flair_tpu_torch", "weights")
    os.makedirs(model_dir, exist_ok=True)
    filename = file_name or os.path.basename(urlparse(url).path)
    cached = os.path.abspath(os.path.join(model_dir, filename))
    if not os.path.exists(cached):
        urlretrieve(url, cached)
    return cached
