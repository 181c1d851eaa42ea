"""Model registry: denoisers and temporal modules by name.

Counterpart of ``flair_tpu/models/registry.py``; this package registers
``bicubic_unet``, ``blur_unet``, ``spynet`` and ``basicvsrpp``."""

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
        from . import adm, sr3, spynet, vsrpp  # noqa: F401  (registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown model: {name}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models():
    from . import adm, sr3, spynet, vsrpp  # noqa: F401
    return sorted(_REGISTRY)
