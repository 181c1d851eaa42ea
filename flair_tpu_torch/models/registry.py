"""Model registry: denoisers and temporal modules by name.

Counterpart of ``flair_tpu/models/registry.py``, with the same names:
``bicubic_unet``, ``blur_unet``, ``superres_unet``, ``encoder_unet``,
``spynet``, ``basicvsrpp``, the face models ``codeformer``,
``vqautoencoder``, ``parsenet``, ``retinaface``, ``vqfr``,
``restoreformer``, ``vqvaegan``, ``bisenet`` and ``yolov5face``, and the
video models ``superslomo``, ``amt`` and ``davsr``."""

from __future__ import annotations

from typing import Any, Callable, Dict

from ..utils.spans import span

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(ctor):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name: {name}")
        _REGISTRY[name] = ctor
        return ctor

    return deco


def get_model(name: str, **kwargs):
    if name not in _REGISTRY:
        _register_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model: {name}; have {sorted(_REGISTRY)}")
    with span("model.build"):
        return _REGISTRY[name](**kwargs)


def list_models():
    _register_all()
    return sorted(_REGISTRY)


def _register_all():
    from . import (adm, amt, bisenet, codeformer, davsr,  # noqa: F401
                   parsenet, restoreformer, retinaface, spynet, sr3,
                   superslomo, vqfr, vsrpp, yolov5face)
