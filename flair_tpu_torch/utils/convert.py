"""Flax parameters → the port's ``state_dict``.

The port names its modules after the flax scopes, so the map is mostly
transposes. Input is the flat flax dict — the format of
``goldens/*/params.npz`` and of ``flair_tpu.utils.checkpoint.flatten_params``:
``"params/down_0/res_block/block1/conv/Conv_0/kernel" → array``.

- the ``params/`` collection prefix and the ``Conv_0`` / ``Dense_0`` /
  ``GroupNorm_0`` scopes of the flax wrapper modules are dropped;
- conv kernels HWIO → OIHW, Conv3d kernels ((3, 1, 1) in the BicubicUNet,
  3×3×3 in the BlurUNet) DHWIO → OIDHW, Dense kernels (in, out) →
  (out, in); all become ``weight``;
- DenseGeneral kernels of multi-head attention are 3-D: ``query`` /
  ``key`` / ``value`` (E, H, Dh) → (H·Dh, E) with bias (H, Dh) → (H·Dh,),
  ``out`` (H, Dh, E) → (E, H·Dh);
- norm ``scale`` → ``weight``;
- the ``batch_stats/`` collection (ParseNet's BatchNorm) → the buffers
  ``running_mean`` / ``running_var``;
- the deformable alignment's ``weight`` (HWIO) → OIHW.

``offset_out`` stays in the reference channel order; the model permutes it
when applied (``models/vsrpp.py::_offset_perm``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_WRAPPER_SCOPE = re.compile(r"^(Conv|Dense|GroupNorm)_\d+$")
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _convert_leaf(name: str, arr: np.ndarray, scope: str):
    if name == "kernel" and arr.ndim == 3:
        if scope == "out":
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        return "weight", arr.reshape(arr.shape[0], -1).T
    if name == "bias" and arr.ndim == 2:
        return name, arr.reshape(-1)
    if name in ("kernel", "weight") and arr.ndim >= 2:
        perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[arr.ndim]
        return "weight", np.transpose(arr, perm)
    if name == "scale":
        return "weight", arr
    return name, arr


def from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax variables (``params/`` and ``batch_stats/``) → state_dict
    of float32 tensors."""
    out = {}
    for key, val in flat.items():
        parts = key.split("/")
        collection = parts[0] if parts[0] in ("params", "batch_stats") else None
        if collection is not None:
            parts = parts[1:]
        parts = [p for p in parts if not _WRAPPER_SCOPE.match(p)]
        arr = np.asarray(val, np.float32)
        if collection == "batch_stats":
            name = _BATCH_STATS[parts[-1]]
        else:
            scope = parts[-2] if len(parts) > 1 else ""
            name, arr = _convert_leaf(parts[-1], arr, scope)
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def from_flax_bicubic_unet(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax BicubicUNet params → ``BicubicUNet`` state_dict."""
    return from_flax(flat)


def from_flax_blur_unet(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax BlurUNet params → ``BlurUNet`` state_dict (the attention
    ``qkv`` Dense keeps its per-head (q, k, v) interleave)."""
    return from_flax(flat)


def from_flax_codeformer(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax CodeFormer / VQAutoEncoder params → the port's state_dict
    (``position_emb`` and ``quantize/embedding`` carry over as they are)."""
    return from_flax(flat)


def from_flax_parsenet(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax ParseNet variables, ``params`` and ``batch_stats`` → the
    port's state_dict."""
    return from_flax(flat)
