"""Checkpoint loading: flat flax ``.npz`` files and upstream torch
checkpoints → the port's ``state_dict``.

Counterpart of the load side of ``flair_tpu/utils/checkpoint.py``:

- ``.npz``: flat flax names, as ``flair_tpu.utils.checkpoint.
  flatten_params`` writes them (the goldens' ``params.npz``), through
  ``convert.from_flax``, the same for every model;
- ``.pt`` / ``.pth``: a reference checkpoint (video_sample.py:327-359,
  facelib/*/__init__.py), through ``convert.convert_<model>``;
- an orbax directory cannot be read without JAX: it raises, and says how
  to write the ``.npz`` instead.

The save side (orbax, training) is not in the port.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional

import numpy as np

from . import convert
from .convert import t2j_conv2d, t2j_conv3d, t2j_linear  # noqa: F401

UPSTREAM = {
    "bicubic_unet": convert.convert_bicubic_unet,
    "blur_unet": convert.convert_blur_unet,
    "codeformer": convert.convert_codeformer,
    "parsenet": convert.convert_parsenet,
    "retinaface": convert.convert_retinaface,
    "spynet": convert.convert_spynet,
}


def load_params(path: str, model_name: str) -> dict:
    """The ``state_dict`` of registry model ``model_name`` from a flat flax
    ``.npz`` or an upstream torch ``.pt`` / ``.pth`` checkpoint."""
    if model_name not in UPSTREAM:
        raise ValueError(f"no converter registered for {model_name!r}; "
                         f"known: {sorted(UPSTREAM)}")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            return convert.from_flax(dict(f))
    if path.endswith((".pt", ".pth")):
        return UPSTREAM[model_name](load_torch_state_dict(path))
    if os.path.isdir(path):
        raise ValueError(
            f"{path} looks like an orbax checkpoint, which the port cannot "
            "read without JAX: write it as a flat .npz with "
            "flair_tpu.utils.checkpoint.flatten_params (np.savez(out, "
            "**flatten_params(params))) and load that")
    raise ValueError(f"unknown checkpoint format: {path} "
                     "(expected .npz, .pt or .pth)")


def flatten_params(tree, sep: str = "/") -> dict[str, np.ndarray]:
    """Nested dicts of arrays → {"a/b/c": array}."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(tree, "")
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray], sep: str = "/") -> dict:
    """{"a/b/c": array} → nested dicts of numpy arrays."""
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A torch checkpoint as numpy, unwrapped from ``state_dict`` /
    ``params_ema`` (checkpoint.py:123-132). Loads tensors only
    (``weights_only``): the file comes from outside the program."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "params_ema" in obj:
        obj = obj["params_ema"]
    return {k: v.detach().numpy() for k, v in obj.items()
            if hasattr(v, "detach")}


def convert_torch_params(
    state: Mapping[str, np.ndarray],
    mapping: Mapping[str, tuple[str, Optional[Callable]]],
) -> dict:
    """Apply a {torch_name: (flax_path, transform)} mapping → nested flax
    params (numpy). ``transform`` defaults to identity; use the t2j_*
    helpers for layout."""
    flat = {}
    for tname, (jpath, tf) in mapping.items():
        if tname not in state:
            raise KeyError(f"missing torch param: {tname}")
        flat[jpath] = (tf or (lambda x: x))(state[tname])
    return unflatten_params(flat)
