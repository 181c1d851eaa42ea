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

The save side: ``save_pytree`` / ``load_pytree`` write and read a
directory of ``.npz`` files, one for each top-level entry of a two-level
dict of arrays (the training runner's ``state_{step:06d}``: the model and
each EMA stream under flat flax names, which ``load_params`` reads, and the
optimizer state). The port writes no orbax.
"""

from __future__ import annotations

import functools
import os
import shutil
from typing import Callable, Mapping, Optional

import numpy as np

from . import convert
from .convert import t2j_conv2d, t2j_conv3d, t2j_linear  # noqa: F401

UPSTREAM = {
    "amt": convert.convert_amt,
    "bicubic_unet": convert.convert_bicubic_unet,
    "bisenet": convert.convert_bisenet,
    "blur_unet": convert.convert_blur_unet,
    "codeformer": convert.convert_codeformer,
    # the auxiliary nets only: the map leaves the regularizer out
    "davsr": convert.convert_davsr_aux,
    "parsenet": convert.convert_parsenet,
    "restoreformer": convert.convert_restoreformer,
    "retinaface": convert.convert_retinaface,
    "spynet": convert.convert_spynet,
    "superslomo": convert.convert_superslomo,
    "vqfr": convert.convert_vqfr,
    "vqvaegan": functools.partial(convert.convert_restoreformer, cross=False),
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


def save_pytree(path: str, tree: Mapping[str, Mapping[str, object]]) -> None:
    """Write ``tree`` ({file: {key: array}}) as ``<path>/<file>.npz``, one
    file per top-level entry; arrays may be numpy or torch (read back as
    numpy). The directory is written beside ``path`` and renamed into
    place, replacing an older one, so a reader never sees half of it."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, leaves in tree.items():
        arrays = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                      else np.asarray(v)) for k, v in leaves.items()}
        np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_pytree(path: str) -> dict:
    """``{file: {key: numpy array}}`` from a ``save_pytree`` directory."""
    tree = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".npz"):
            with np.load(os.path.join(path, fname), allow_pickle=False) as f:
                tree[fname[:-4]] = dict(f)
    return tree


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
