"""Model registry: denoisers and temporal modules by name.

Counterpart of ``flair_tpu/models/registry.py``; this package registers
``bicubic_unet``, ``blur_unet``, ``spynet``, ``basicvsrpp``, ``codeformer``,
``vqautoencoder``, ``parsenet`` and ``retinaface``."""

from __future__ import annotations

from typing import Any, Callable, Dict

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
    return _REGISTRY[name](**kwargs)


def list_models():
    _register_all()
    return sorted(_REGISTRY)


def _register_all():
    from . import (adm, codeformer, parsenet, retinaface, sr3,  # noqa: F401
                   spynet, vsrpp)
