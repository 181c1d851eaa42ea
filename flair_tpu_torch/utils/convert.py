"""Flax parameters → the port's ``state_dict``.

The port names its modules after the flax scopes, so the map is mostly
transposes. Input is the flat flax dict — the format of
``goldens/*/params.npz`` and of ``flair_tpu.utils.checkpoint.flatten_params``:
``"params/down_0/res_block/block1/conv/Conv_0/kernel" → array``.

- the ``params/`` collection prefix and the ``Conv_0`` / ``Dense_0`` scopes
  of the flax wrapper modules are dropped;
- conv kernels HWIO → OIHW, Conv3d kernels ((3, 1, 1) in the BicubicUNet,
  3×3×3 in the BlurUNet) DHWIO → OIDHW, Dense kernels (in, out) →
  (out, in); all become ``weight``;
- norm ``scale`` → ``weight``;
- the deformable alignment's ``weight`` (HWIO) → OIHW.

``offset_out`` stays in the reference channel order; the model permutes it
when applied (``models/vsrpp.py::_offset_perm``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_WRAPPER_SCOPE = re.compile(r"^(Conv|Dense)_\d+$")


def _convert_leaf(name: str, arr: np.ndarray):
    if name in ("kernel", "weight") and arr.ndim >= 2:
        perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[arr.ndim]
        return "weight", np.transpose(arr, perm)
    if name == "scale":
        return "weight", arr
    return name, arr


def from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat flax params → state_dict of float32 tensors."""
    out = {}
    for key, val in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        parts = [p for p in parts if not _WRAPPER_SCOPE.match(p)]
        name, arr = _convert_leaf(parts[-1], np.asarray(val, np.float32))
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
