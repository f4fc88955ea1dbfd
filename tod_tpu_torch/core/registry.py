"""Model registry: name -> constructor (counterpart of the JAX package's
``core/registry.py``): ``get_model("yolact_r18_fpn", cfg)``."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn: Callable):
        if name in _REGISTRY:
            raise ValueError(f"model {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, *args, **kwargs):
    """The model registered as ``name``, built with the arguments (the
    YOLACT family's constructors live in ``models/yolact.py``, imported
    here so that they are registered)."""
    import tod_tpu_torch.models.yolact  # noqa: F401

    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
    return ctor(*args, **kwargs)


def list_models() -> list[str]:
    import tod_tpu_torch.models.yolact  # noqa: F401

    return sorted(_REGISTRY)
