"""Model zoo of the port: GPT-2, ResNet-18/50, ViT, BERT, Llama, the MoE
decoders and the pipelined GPT-2, Llama and BERT; the other models of the
JAX package register here as later slices port them."""

from __future__ import annotations

_REGISTRY: dict[str, callable] = {}
# Models without activation checkpointing: the reference's have no
# ``remat`` field, and its ``cli`` refuses ``train.remat`` for them.
_NO_REMAT: set[str] = set()
# Models with routed experts (mesh.ep cuts them) and pipelined models (the
# Trainer's pipeline fence refuses mesh.ep on them).
_EXPERTS: set[str] = set()
_PIPELINED: set[str] = set()


def register(name: str, *, remat: bool = True, experts: bool = False,
             pipelined: bool = False):
    def deco(fn):
        _REGISTRY[name] = fn
        for on, where in ((not remat, _NO_REMAT), (experts, _EXPERTS),
                          (pipelined, _PIPELINED)):
            if on:
                where.add(name)
        return fn

    return deco


def supports_remat(name: str) -> bool:
    return name not in _NO_REMAT


def has_experts(name: str) -> bool:
    return name in _EXPERTS


def is_pipelined(name: str) -> bool:
    return name in _PIPELINED


def get_model(name: str, **kwargs):
    """Construct a model by registry name (e.g. 'gpt2')."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


from . import bert, gpt2, llama, moe, pipeline, resnet, vit  # noqa: E402,F401,E501
