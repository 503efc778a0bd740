"""Model zoo of the port: GPT-2 and ResNet-18/50 so far; the other models
of the JAX package register here as later slices port them."""

from __future__ import annotations

_REGISTRY: dict[str, callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """Construct a model by registry name (e.g. 'gpt2')."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


from . import gpt2, resnet  # noqa: E402,F401
